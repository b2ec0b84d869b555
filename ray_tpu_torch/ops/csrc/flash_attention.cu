// Flash attention for Hopper (sm_90a): forward (with and without the
// log-sum-exp residual) and the two tiled backward kernels.
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   bf16 inputs (the train step's)          f32 inputs
//   fwd_kernel_sm90<.., WRITE_LSE=false>    fwd_kernel<.., WRITE_LSE=false>  <- _attn_fwd_kernel      (B1)
//   fwd_kernel_sm90<.., WRITE_LSE=true>     fwd_kernel<.., WRITE_LSE=true>   <- _attn_fwd_kernel_lse  (B2)
//   bwd_dq_kernel_tc                        bwd_dq_kernel                    <- _attn_bwd_dq_kernel   (B3)
//   bwd_dkv_kernel_tc                       bwd_dkv_kernel                   <- _attn_bwd_dkv_kernel  (B4)
//
// Layout [BH, T, D] for q/do/o and [BH, S, D] for k/v, row-major and
// contiguous; lse and delta are [BH, T] f32; dq, dk and dv are f32. D is 64
// or 128. All sums are f32.
//
// What bounds them on the card. The least time for the work is set by the
// bytes at the train step's shape (causal, T = 1024, D = 64: ~256 flops per
// byte moved, in the forward and in each backward kernel, just under the
// ~295 at which an H100's bf16 tensor cores stop waiting on memory), so a
// fast kernel reads each input once and keeps everything O(T*S) on chip,
// and then has to keep the tensor cores busy: at ~256 flops a byte the
// bytes and the products take about as long, and the online softmax's work
// on the CUDA cores has to hide under both.
//
// Exactness, in every bf16 kernel. q, k, v and do are bf16, so their
// products are exact in f32 and S = q.k^T and dP = do.v^T match the f32
// plain versions up to the order of the sums. P (in P.V and P^T.dO) and dS
// (in dS.K and dS^T.Q) are f32 values made on chip; rounded once to bf16
// they would miss the limits of chip_smoke.py several times over
// (tests/test_torch_ops.py, test_tensor_core_operands_need_the_hi_lo_split).
// Each is split into hi = bf16(x) and lo = bf16(x - hi), both multiplied into
// the same f32 sum: the error falls to ~2^-16 of x, and the kernels compute
// what the TPU kernels' f32 dots compute. The split costs 1.5x the useful
// tensor flops.
//
// The bf16 forward (fwd_kernel_sm90, last section) is built from Hopper's
// own parts, as FlashAttention-3 is:
//   1. Work split. A persistent grid, one block per SM, takes work items of
//      (128-row q tile, bh) in units of two q tiles of one head, the longest
//      and the shortest causal rows together, so every unit holds like work
//      and the blocks at work at one time share a few heads' K and V in L2.
//      Three warpgroups: a producer, whose one elected thread issues every
//      load, and two consumers of 64 q rows each (wgmma's M). setmaxnreg
//      moves registers from the producer (24) to the consumers (240), whose
//      S, P (hi and lo) and output sums live in registers.
//   2. TMA with mbarrier rings. Q loads once an item, behind its own full and
//      empty barriers, so the next item's Q lands while this item's last
//      products run; K and V tiles (128 keys at D = 64, 64 at D = 128) stream
//      through a ring of 4 stages, so loads run ahead of the products without
//      a block-wide barrier. The tensor maps are 3-D [BH, S, D] in boxes of
//      [1, rows, 64] with the 128-byte swizzle (64 bf16 a row: D = 128 takes
//      two boxes), so rows past T or S are zero-filled within the head: a
//      flat [BH*S, D] map would read the next head's rows there, and those
//      keys are masked but 0 * inf would still poison a sum, as the TPU
//      kernel's own zeroing of V's padding rows guards against. The maps are
//      encoded on the host at each call.
//   3. S = Q.K^T on wgmma m64n128k16 (m64n64k16 at D = 128) with both
//      operands read from shared memory (K-major, descriptors in the swizzle
//      TMA wrote): no ldmatrix, no warp reading the whole tile for its rows.
//   4. Softmax on the accumulator fragment: a row spans the 4 lanes of a
//      quad, in four partial maxima and sums a row. Tiles off the diagonal
//      and inside S skip the mask. exp2 with scale * log2(e) folded into one
//      FMA (flash_fwd requires scale > 0).
//   5. acc += P_hi.V + P_lo.V on wgmma m64nDk16 with A from registers: the
//      S accumulator's fragment is the A operand's layout pairwise, so P goes
//      from the softmax into the product without shared memory; V is the
//      MN-major B operand (the descriptor's transpose bit).
//   6. Overlap. A consumer issues S_j = Q.K_j^T with P_{j-1}.V_{j-1}, then
//      runs the softmax of tile j while P_{j-1}.V_{j-1} is still on the
//      tensor cores (commit groups, wait_group<1>); the two consumers issue
//      their products in turn (named barriers), so one's softmax runs under
//      the other's products.
// What holds it back (clock64 stamps in a consumer, on an H100): a wgmma
// whose A is in registers holds its warps until it has read them, so a
// consumer spends ~800 cycles a tile issuing S and P.V and then ~1200-1500
// in the softmax and ~400 splitting P; that CUDA-core and exp work, not the
// bytes or the tensor cores (busy about half the time), sets the pace. A
// third consumer (192 rows, 160 registers each) moved the contention to the
// exp unit and issue slots without a gain.

// The bf16 backward kernels (*_tc) run on mma.sync m16n8k16 (bf16
// operands, f32 sums), fed from shared memory by ldmatrix, and the streamed
// tiles arrive by cp.async into a two-stage ring, so the next tile's load
// overlaps this tile's products.
//   * mma.sync takes its A operand in the layout of its own accumulator, so
//     both terms of the split go straight from registers into the next
//     product.
//   * Tiles of 64 rows, 4 warps, each warp owning 16 rows of the block's
//     resident operand (q rows in bwd_dq, k rows in bwd_dkv), whose
//     fragments and sums stay in registers. Shared rows are padded by 16
//     bytes so the 8 row addresses of an ldmatrix hit 8 distinct bank
//     groups. Rows at or past T or S are zero-filled by cp.async (src-size
//     0), never read: in a flat [BH*T, D] view they would be the next head's
//     rows.
//   * Each streamed tile is walked in chunks of 16 columns (q columns in
//     bwd_dkv, keys in bwd_dq): S, dP, P and dS of a chunk live in 8
//     registers each, so only the warp's own rows stay resident (dK and dV
//     in bwd_dkv; Q, dO and dQ fragments in bwd_dq), and D = 128 fits 4
//     warps without a spill. On the causal diagonal, bwd_dq skips the chunks
//     that lie wholly above the warp's rows.
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

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked
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

// ============================================== forward on Hopper (bf16, sm_90a)
//
// fwd_kernel_sm90 replaces _attn_fwd_kernel (WRITE_LSE = false, B1) and
// _attn_fwd_kernel_lse (WRITE_LSE = true, B2) of ray_tpu/ops/flash_attention.py
// for bf16 inputs. See the file's header for what bounds it and why it is
// built this way.

constexpr int FWD_BQ = 128;       // q rows per block: 64 per consumer warpgroup
constexpr int FWD_THREADS = 384;  // warpgroups 0 and 1 consume, warpgroup 2 loads
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile sizes and shared memory of one block, in bytes. Every tile is a stack
// of 64-column boxes as TMA writes them with the 128-byte swizzle:
// [D / 64][rows][64]. At D = 128 a tile of 64 keys keeps S, P (hi and lo)
// and the output sums within the consumers' 240 registers.
template <int D>
struct FwdCfg {
  static constexpr int BN = D == 64 ? 128 : 64;  // keys per K/V tile (the N of S = Q.K^T)
  static constexpr int STAGES = 4;               // K/V ring depth
  static constexpr int Q_BYTES = FWD_BQ * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  // + 1024: the dynamic base is aligned up to the swizzle's 1024-byte period.
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// One arrival on the barrier from the threads with `pred` (a predicate in the
// instruction, not a branch: no divergent path among the warpgroup's wgmma).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               ::"r"(bar), "r"(static_cast<int>(pred)) : "memory");
}
// Until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// Named barriers 1 and 2 (of 256 threads) order the two consumer
// warpgroups' products: warpgroup w syncs on 1 + w when it may issue, and
// arrives on the other's when it has issued.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_if(int id, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n"
               ::"r"(id), "r"(static_cast<int>(pred)) : "memory");
}

// One box [64 columns, `rows` rows, 1 head] of a 3-D [heads, rows, D] map at
// (column c0, row, head) into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(row), "r"(head)
      : "memory");
}
// Rows [row, row + ROWS) of head `head`, all D columns, one box per 64.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const CUtensorMap* map, uint32_t bar, int head,
                                          int row) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_3d(dst + c * ROWS * 64, map, bar, c * 64, row, head);
}

// A wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (in 16-byte units), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers a wgmma writes or reads asynchronously, so the compiler
// neither moves nor reuses them between the issue and the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 sums in d (N / 2 per thread). _ss: A and B
// both K-major from shared memory (SCALE_D = 0 overwrites d). _rs: A from
// registers in the accumulator's own layout, B MN-major (transposed) from
// shared memory, added to d.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(SCALE_D));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(SCALE_D));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile of the online softmax for this thread's rows r0 and r0 + 8,
// in log2 units: s holds raw Q.K^T (N / 4 column groups of 8, as the wgmma
// accumulator lays them out) and leaves holding P = 2^(s * sl2 - m), 0 where
// masked; m (the running row max of s * sl2) and l (this thread's part of
// the row sum) are updated, and alpha is the factor that rescales the sums
// made under the old max. c0 is the key position of s[0]. sl2 = scale *
// log2(e) folds the scale into exp2's argument, one FMA: exp(scale * s - M)
// = 2^(s * sl2 - M * log2(e)), and with scale > 0 the max of s * sl2 is the
// max of s times sl2.
template <bool MASK, bool CAUSAL, int N>
__device__ __forceinline__ void softmax_body(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int r0, int c0, int seq_k, float sl2) {
  auto ok = [&](int i) {
    const int qp = r0 + 8 * (i % 4 / 2), kp = c0 + 8 * (i / 4) + i % 2;
    return kp < seq_k && (!CAUSAL || qp >= kp);
  };
  // Four partial maxima and sums a row (k = which of them), so no chain of
  // dependent instructions runs the length of the row.
  auto k = [](int i) { return i / 4 % 2 * 2 + i % 2; };
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[r][j] = BIG_NEG, rs[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (MASK) s[i] = ok(i) ? s[i] * sl2 : BIG_NEG;
    mx[i % 4 / 2][k(i)] = fmaxf(mx[i % 4 / 2][k(i)], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mr = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])));
    const float mn = fmaxf(m[r], MASK ? mr : mr * sl2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mr = m[i % 4 / 2];
    s[i] = MASK ? (ok(i) ? ex2(s[i] - mr) : 0.f) : ex2(fmaf(s[i], sl2, -mr));
    rs[i % 4 / 2][k(i)] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

// The softmax of the tile of 2N keys whose first key is k0, for a warpgroup
// whose first row is row0: only a tile on the diagonal or past seq_k has
// masked entries.
template <bool CAUSAL, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int row0, int r0, int tg,
                                             int seq_k, float sl2) {
  if (k0 + 2 * N > seq_k || (CAUSAL && k0 + 2 * N - 1 > row0))
    softmax_body<true, CAUSAL>(s, m, l, alpha, r0, k0 + 2 * tg, seq_k, sl2);
  else
    softmax_body<false, CAUSAL>(s, m, l, alpha, r0, k0 + 2 * tg, seq_k, sl2);
}

// P (s after the softmax) as the A operand of P.V: the accumulator's 16-key
// group c is the A fragment of keys 16c..16c+15, split into hi = bf16(P) and
// lo = bf16(P - hi) (a P rounded once misses the limits: see the header).
template <int N>
__device__ __forceinline__ void split_p(const float (&s)[N], uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16x2(s[8 * c + 2 * r], s[8 * c + 2 * r + 1], hi[c][r], lo[c][r]);
}

// S = Q.K^T of one tile: Q (this warpgroup's 64 rows at q_addr) and K (the
// stage's 2N rows at k_addr), both K-major, 16 columns of D per wgmma.
// Within a 128-byte swizzled row, the k-th 16 columns start 32k bytes in.
template <int D, int N>
__device__ __forceinline__ void issue_s(float (&s)[N], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint64_t a = smem_desc(q_addr + kc / 4 * FWD_BQ * 128 + kc % 4 * 32, 16, 1024);
    const uint64_t b = smem_desc(k_addr + kc / 4 * 2 * N * 128 + kc % 4 * 32, 16, 1024);
    if (kc == 0)
      wgmma_ss<0>(s, a, b);
    else
      wgmma_ss<1>(s, a, b);
  }
}

// acc += P_hi.V + P_lo.V of one tile, 16 keys per wgmma pair. V is the
// MN-major B operand: 8 keys of 128 bytes a 1024-byte swizzle atom (SBO),
// its 64-column boxes 16 NC * 128 bytes apart (LBO), NC groups of 16 keys.
template <int D, int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p_hi)[NC][4],
                                         const uint32_t (&p_lo)[NC][4], uint32_t v_addr) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint64_t b = smem_desc(v_addr + c * 16 * 128, 16 * NC * 128, 1024);
    wgmma_rs(acc, p_hi[c], b);
    wgmma_rs(acc, p_lo[c], b);
  }
}

#ifdef RT_FWD_TIMELINE
// Cycle stamps of block 0's two consumers (their thread 0) for each K/V tile
// after an item's first, [consumer][tile][event]: 0 the tile's K and V
// landed, 1 S and the previous tile's P.V issued, 2 S in, 3 softmax done,
// 4 P.V in, 5 P split. Only ray_tpu_torch/ops/kernel_ab.py's timeline build
// defines RT_FWD_TIMELINE (chip_smoke.py phase 2 reads it through
// rt_fwd_timeline); the library the port loads has no stamps.
constexpr int FWD_TIMELINE_TILES = 64;
__device__ long long fwd_timeline[2][FWD_TIMELINE_TILES][6];
__device__ __forceinline__ void fwd_stamp(int wg, int tile, int ev, bool pred) {
  long long* at = &fwd_timeline[wg][min(tile, FWD_TIMELINE_TILES - 1)][ev];
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b64 [%0], %1;\n}\n" ::"l"(at),
               "l"(clock64()), "r"(static_cast<int>(pred)) : "memory");
}
#define FWD_STAMP(tile, ev) fwd_stamp(wg, tile, ev, blockIdx.x == 0 && tid == 0)
#else
#define FWD_STAMP(tile, ev)
#endif

// K/V tiles a q tile starting at row q0 takes: all of S, or with CAUSAL
// none above the diagonal.
template <bool CAUSAL, int BN>
__device__ __forceinline__ int kv_tiles(int q0, int seq_k) {
  const int n = (seq_k + BN - 1) / BN;
  return CAUSAL ? min(n, (q0 + FWD_BQ - 1) / BN + 1) : n;
}

// Work comes in units of two q tiles of one head, q tile n_qt - 1 - p and q
// tile p (the middle one alone when n_qt is odd), so causal units hold like
// work, and the blocks at work at one time share a few heads' K and V in L2.
// Item j of unit u: its head and first q row; false past the unit's last.
__device__ __forceinline__ bool unit_item(int u, int j, int n_qt, int& head, int& q0) {
  const int n_pairs = (n_qt + 1) / 2, p = u % n_pairs, qt = j == 0 ? n_qt - 1 - p : p;
  head = u / n_pairs;
  q0 = qt * FWD_BQ;
  return j == 0 || qt != n_qt - 1 - p;
}

// Persistent: block b takes units b, b + gridDim.x, ... of the
// (n_qt + 1) / 2 * bh units. The K/V ring runs on across items, and the
// next item's Q loads while this item's last products and its stores run.
template <int D, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1) fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse, int bh,
    int seq_q, int seq_k, float scale) {
  using Cfg = FwdCfg<D>;
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES;
  extern __shared__ unsigned char fwd_smem[];
  // The 128-byte swizzle is a function of the shared address bits, with a
  // period of 1024 bytes: TMA and the wgmma descriptors agree on it only
  // from a 1024-byte aligned base.
  bf16* qs = reinterpret_cast<bf16*>(fwd_smem + (1024 - smem_u32(fwd_smem) % 1024) % 1024);
  bf16* ks = qs + FWD_BQ * D;       // [STAGES][D / 64][BN][64]
  bf16* vs = ks + STAGES * BN * D;  // [STAGES][D / 64][BN][64]
  const uint32_t q_full = smem_u32(vs + STAGES * BN * D);  // the item's Q landed
  const uint32_t q_empty = q_full + 8;                     // both consumers are done with Q
  const uint32_t full_bar = q_empty + 8;                   // [STAGES]: the stage's K and V landed
  const uint32_t empty_bar = full_bar + 8 * STAGES;        // [STAGES]: both consumers are done with it

  const int n_qt = (seq_q + FWD_BQ - 1) / FWD_BQ, n_units = (n_qt + 1) / 2 * bh;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform, and visibly so to the compiler: a wgmma in a path it takes
  // for divergent is serialized.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one thread keeps Q and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int it = 0, n = 0, head, q0;  // K/V tiles (the ring's position) and items loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item(u, j, n_qt, head, q0); ++j, ++n) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN>(q0, seq_k);
          mbar_wait(q_empty, (n & 1) ^ 1);  // passes at once for the first item
          mbar_expect_tx(q_full, Cfg::Q_BYTES);
          load_rows<FWD_BQ, D>(qs, &q_map, q_full, head, q0);
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++it) {
            const int st = it % STAGES;
            mbar_wait(empty_bar + 8 * st, (it / STAGES & 1) ^ 1);  // passes at once on the first lap
            const uint32_t full = full_bar + 8 * st;
            mbar_expect_tx(full, 2 * Cfg::KV_BYTES);  // out-of-range rows are zero-filled and counted
            load_rows<BN, D>(ks + st * BN * D, &k_map, full, head, kt * BN);
            load_rows<BN, D>(vs + st * BN * D, &v_map, full, head, kt * BN);
          }
        }
    }
  } else {  // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64) of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
    float s[BN / 2], acc[D / 2], alpha[2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];

    int it = 0, n = 0, head, q0;  // K/V tiles and items consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int j = 0; j < 2 && unit_item(u, j, n_qt, head, q0); ++j, ++n) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN>(q0, seq_k);
        const int row0 = q0 + wg * 64;
        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};  // l: this thread's part of the row sum

        mbar_wait(q_full, n & 1);
        bar_arrive_if(1, wg == 1);  // warpgroup 0 issues first
        // Tile 0: S_0 alone.
        mbar_wait(full_bar + 8 * (it % STAGES), it / STAGES & 1);
        bar_sync(1 + wg);
        keep(s);
        wgmma_fence();
        issue_s<D>(s, q_addr, smem_u32(ks + it % STAGES * BN * D));
        wgmma_commit();
        keep(s);
        bar_arrive_if(2 - wg, wg == 0 || n_kv_tiles > 1);  // the other warpgroup's turn
        wgmma_wait<0>();
        keep(s);
        mbar_arrive_if(q_empty, tid == 0 && n_kv_tiles == 1);  // the last S is in: Q may go
        softmax_tile<CAUSAL>(s, m, l, alpha, 0, row0, r0, tg, seq_k, sl2);
        split_p(s, p_hi, p_lo);
        // Tile kt: issue S_kt = Q.K_kt^T and acc += P_{kt-1}.V_{kt-1} in turn with
        // the other warpgroup, so its softmax runs under these products; then
        // this tile's softmax while P_{kt-1}.V_{kt-1} is still on the tensor cores.
        for (int kt = 1; kt < n_kv_tiles; ++kt) {
          const int st = (it + kt) % STAGES, prev = (it + kt - 1) % STAGES;
          mbar_wait(full_bar + 8 * st, (it + kt) / STAGES & 1);
          FWD_STAMP(it + kt, 0);
          bar_sync(1 + wg);
          keep(s);
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          wgmma_fence();
          issue_s<D>(s, q_addr, smem_u32(ks + st * BN * D));
          wgmma_commit();
          issue_pv<D>(acc, p_hi, p_lo, smem_u32(vs + prev * BN * D));
          wgmma_commit();
          FWD_STAMP(it + kt, 1);
          keep(s);
          keep(acc);
          bar_arrive_if(2 - wg, wg == 0 || kt + 1 < n_kv_tiles);
          wgmma_wait<1>();  // S_kt is in
          keep(s);
          FWD_STAMP(it + kt, 2);
          mbar_arrive_if(q_empty, tid == 0 && kt + 1 == n_kv_tiles);
          softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN, row0, r0, tg, seq_k, sl2);
          FWD_STAMP(it + kt, 3);
          wgmma_wait<0>();  // P_{kt-1}.V_{kt-1} is in: its P and its stage are free
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          FWD_STAMP(it + kt, 4);
          mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[i % 4 / 2];
          split_p(s, p_hi, p_lo);
          FWD_STAMP(it + kt, 5);
        }
        it += n_kv_tiles;
        const int last = (it - 1) % STAGES;
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        wgmma_fence();
        issue_pv<D>(acc, p_hi, p_lo, smem_u32(vs + last * BN * D));
        wgmma_commit();
        keep(acc);
        wgmma_wait<0>();
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        mbar_arrive_if(empty_bar + 8 * last, tid == 0);

#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r;
          const float lsafe = fmaxf(quad_sum(l[r]), 1e-30f), linv = 1.f / lsafe;
          if (qp >= seq_q) continue;
          bf16* orow = o + (static_cast<size_t>(head) * seq_q + qp) * D;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + 2 * tg) =
                __floats2bfloat162_rn(acc[4 * c + 2 * r] * linv, acc[4 * c + 2 * r + 1] * linv);
          if (WRITE_LSE && tg == 0) lse[static_cast<size_t>(head) * seq_q + qp] = m[r] * LN2 + logf(lsafe);
        }
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

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A contiguous [heads, rows, D] bf16 tensor as a 3-D TMA map read in boxes of
// 64 columns by box_rows rows of one head, 128-byte swizzled. A box's rows
// past `rows` are zero-filled: they never come from the next head. TMA needs
// the base 16-byte aligned and every stride a multiple of 16 bytes: the
// wrapper checks the first, and D in {64, 128} gives the second.
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int heads, int rows, int D, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1}, unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                     int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = encode_rows(&qm, q, bh, seq_q, D, FWD_BQ);
  if (err == cudaSuccess) err = encode_rows(&km, k, bh, seq_k, D, FwdCfg<D>::BN);
  if (err == cudaSuccess) err = encode_rows(&vm, v, bh, seq_k, D, FwdCfg<D>::BN);
  if (err != cudaSuccess) return err;
  // One block per SM (or per unit of work, if fewer), each walking its units.
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const size_t smem = FwdCfg<D>::BYTES;
  const dim3 grid(min(((seq_q + FWD_BQ - 1) / FWD_BQ + 1) / 2 * bh, sm_count[dev]));
  bf16* ot = static_cast<bf16*>(o);
  if (causal) {
    return lse ? launch<fwd_kernel_sm90<D, true, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                      lse, bh, seq_q, seq_k, scale)
               : launch<fwd_kernel_sm90<D, true, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                       lse, bh, seq_q, seq_k, scale);
  }
  return lse ? launch<fwd_kernel_sm90<D, false, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                     lse, bh, seq_q, seq_k, scale)
             : launch<fwd_kernel_sm90<D, false, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                      lse, bh, seq_q, seq_k, scale);
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
  RT_DISPATCH(fwd, fwd_sm90, q, k, v, o, static_cast<float*>(lse), bh, seq_q, seq_k, scale,
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

#ifdef RT_FWD_TIMELINE
// Copies the stamps into dst (host memory, [2][64][6] int64) and clears them.
int rt_fwd_timeline(void* dst) {
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, fwd_timeline, sizeof(fwd_timeline));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, fwd_timeline);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(fwd_timeline));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
