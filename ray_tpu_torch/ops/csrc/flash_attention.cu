// Flash attention for Hopper (sm_90a): forward (with and without the
// log-sum-exp residual) and the two tiled backward kernels.
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   bf16 inputs (the train step's)          f32 inputs
//   fwd_kernel_sm90<.., WRITE_LSE=false>    fwd_kernel<.., WRITE_LSE=false>  <- _attn_fwd_kernel      (B1)
//   fwd_kernel_sm90<.., WRITE_LSE=true>     fwd_kernel<.., WRITE_LSE=true>   <- _attn_fwd_kernel_lse  (B2)
//   bwd_dq_kernel_sm90                      bwd_dq_kernel                    <- _attn_bwd_dq_kernel   (B3)
//   bwd_dkv_kernel_sm90                     bwd_dkv_kernel                   <- _attn_bwd_dkv_kernel  (B4)
//
// Layout [BH, T, D] for q/do/o and [BH, S, D] for k/v, row-major and
// contiguous; lse and delta are [BH, T] f32; dq, dk and dv are f32. D is 64,
// 96, 128, 256 or 512; the wrappers (flash_attention.py) run any other head
// dim up to 512, as the TPU kernels take any, at the next of these,
// zero-padded. Any number of heads BH, as the TPU kernels' grid takes: the
// Hopper kernels are persistent and the f32 kernels fold the head into
// gridDim.x; every offset into a tensor is formed in size_t. All sums are
// f32.
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
// tensor flops in the forward, 12D flops a (q, k) pair for 8D useful in
// bwd_dkv, 8D for 6D in bwd_dq.
//
// The bf16 forward (fwd_kernel_sm90, its own section) is built from Hopper's
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

// The bf16 backward (bwd_dkv_kernel_sm90, bwd_dq_kernel_sm90, the last
// section) is built from the forward's parts, as two kernels, and runs
// where the forward does: at the train step's shape its CUDA-core work,
// not the bytes or the tensor cores, sets the pace (cycle stamps of a tile
// a consumer warpgroup streams, on an H100, `kernel_ab --timeline`: in
// bwd_dkv ~800 issuing S^T, dP^T and the last tile's products, ~700-800
// making P^T and dS^T (32 exp2 a thread a tile), ~400-450 splitting them;
// the tensor cores busy about two thirds of the time).
//   1. Two kernels, each output row written by one block with its sums in
//      one order: no atomics, so a train step's losses repeat bitwise run
//      to run (chip_smoke.py phases 6, 14c and 14d require it), where
//      FlashAttention-3's fused backward adds dq with float atomics. The
//      price: both recompute S and dP.
//   2. bwd_dkv: work items of 128 k rows of one head, in the forward's
//      persistent units (the longest causal item with the shortest); a
//      producer warpgroup's one warp loads K and V once an item by TMA and
//      streams the Q and dO tiles (64 q rows; 32 at D = 128) of the q tiles
//      that see the item through a 4-stage mbarrier ring. Two consumer
//      warpgroups of 64 k rows each compute S^T = K.Q^T and dP^T = V.dO^T on
//      SS wgmma, P^T and dS^T in registers, and dV += P^T.dO, dK += dS^T.Q
//      on RS wgmma with dO and Q MN-major (V's role in the forward's P.V),
//      dK and dV held in registers for the item. With D = 64, tile t's S^T
//      and dP^T are issued with tile t-1's products, so P^T and dS^T are
//      made while the tensor cores run the last tile's; at D = 128, dK and
//      dV take 128 of 240 registers, so tiles are 32 q rows (64 spilled)
//      and a tile's products go in turn (pipelined, 32-row tiles spilled
//      too). A causal warpgroup skips the q tiles wholly above its rows
//      (warpgroup 1's first 64 q rows of an item).
//   3. bwd_dq: the forward's structure without the online max (lse is
//      known, nothing is rescaled): items of 128 q rows, Q and dO loaded
//      once, K and V tiles of 64 keys through the ring, S = Q.K^T and dP =
//      dO.V^T on SS wgmma (V K-major, as K), dQ += dS.K on RS wgmma (K
//      MN-major); tile kt's S and dP issued with tile kt-1's product, the
//      two consumers issuing in turn (named barriers: 0.0669 ms at [96,
//      1024, 64] against 0.0738 without). 128-key tiles left no registers
//      for two tiles and ptxas serialized the wgmma (0.0882 ms).
//   4. lse and delta: their [BH, T] f32 rows are 4T bytes apart, not a
//      multiple of 16 for every T (T = 1), so TMA cannot load them. In
//      bwd_dkv the producer warp's 32 lanes copy a tile's by cp.async into
//      shared slots beside its Q/dO stage, each lane's copies counted on
//      the stage's full barrier (cp.async.mbarrier.arrive.noinc: 1 + 32
//      arrivals); bwd_dq's consumers load their own rows' once an item.
//      Both zero-fill past T, and q rows at or past T are masked
//      explicitly (with Q zero-filled, S = 0 and lse = 0 would give P = 1).
//   5. Rows past T or S come from the 3-D [BH, rows, D] tensor maps' zero
//      fill, never from the next head (tests/test_torch_cuda.py's flat-map
//      mutant puts inf there).
//   6. The split: hi = x with its low 16 bits cleared (bf16 toward zero,
//      one byte permute packs a pair) and lo = bf16(x - hi) to nearest, so
//      one conversion a pair instead of two (the split ~534 -> ~400 cycles
//      a tile in bwd_dkv); the error stays under 2^-16 of x and unbiased.
//      dS is split before its scale, taken once on dK and dQ when the item
//      ends (one multiply an element less).
//   7. wgmma serialization and registers: the first product of S and dP
//      takes its sums write-only (wgmma_ss_fresh), else the last tile's
//      values stay alive across the loop and bwd_dkv at D = 128 spilled
//      and ptxas serialized its wgmma; the warpgroup index comes from a
//      shuffle, the first tile is peeled and barrier arrivals are
//      predicates, as in the forward. The 128-byte swizzle's 1024-byte
//      alignment holds for every TMA destination: each Q/dO stage is a
//      multiple of 1024 bytes and the lse/delta slots lie past all tiles.
//   8. Host time: each call encodes four tensor maps (30-60 us a call on
//      the card's host, about the parent's; not cached by pointer).
// f32 inputs keep the first kernels below: the tensor cores take f32 only as
// TF32 or through a three-way bf16 split, and the f32 path exists for the
// tests.
//
// The Hopper kernels at D = 256 (Gemma-2B's head dim) and 96 (Phi-3-mini's).
// A consumer thread has 240 registers and a block 227 KB of shared memory;
// at 256 an output's f32 sums for 64 rows take 128 of those registers, and
// Q for 128 rows 64 KB. So:
//   * forward: 32-key K/V tiles in a ring of four stages (S and P 32
//     registers; Q plus the ring 192 KB); P.V is two m64n128 products a
//     16-key group, into the two halves of the sums (wgmma_rs_at).
//   * bwd_dq: Q and dO of the item 128 KB, so 32-key K/V tiles in three
//     stages (224 KB); dQ as the forward's sums. Still pipelined (tile kt's
//     S and dP with tile kt-1's dQ product): 0.2288 ms at [32, 2048, 256]
//     against 0.2351 with each tile's products in turn, on an H100.
//   * bwd_dkv: dK and dV would take 256 registers: the consumers make them
//     in two passes over the item's q tiles, 128 columns each, recomputing
//     S^T and dP^T (their exp and split: 4/3 the tensor work of one pass,
//     twice the CUDA-core work); K and V stay loaded for both passes.
//   * the wgmma descriptors of a tile are its first plus constant offsets,
//     made at each use: descriptors of a resident operand held across the
//     tile loop took registers that D = 256 does not have (ptxas spilled).
// D = 96 is 192 bytes a row, which no swizzle spans: its tiles are three
// 32-column boxes with the 64-byte swizzle (Lay), the descriptors take that
// swizzle, and P.V is one m64n96 product. Its forward takes D = 64's
// 128-key tiles, and bwd_dkv pipelines 32-row q tiles (dK and dV take 96
// registers, not 128).
//
// The Hopper kernels at D = 512. An item's 128 rows no longer fit: Q alone
// would take 128 KB and an output's sums for 64 rows 256 registers a thread.
// So at 512 an item is 64 rows (Items<512>) and the two consumer warpgroups
// split its output columns instead of its rows: both make S (and dP) for the
// item's 64 rows over all 512 columns, each holds the sums of its own 256
// output columns (in 128 registers, as at 256), and the streamed tiles are
// shared. The price is S and dP made twice, on the tensor cores:
//   * forward: Q 64 KB, 32-key K/V tiles in two stages (192 KB); warpgroup
//     w makes O's columns [256 w, 256 w + 256) from V's boxes 4w-4w+3, and
//     warpgroup 0 writes lse (both hold the same m and l);
//   * bwd_dq: Q and dO 128 KB, 16-key K/V tiles (m64n16 S and dP) in three
//     stages (224 KB); dQ's columns split as O's;
//   * bwd_dkv: K and V 128 KB, 16-row Q/dO tiles in three stages; each
//     warpgroup's 256 dK and dV columns in two passes of 128, recomputing
//     S^T and dP^T (four times S^T's tensor work, as a price of no atomics).
// Past 512, Q, K and V tiles of 64 rows no longer leave room for a stream:
// the wrappers refuse D > 512.
//
// The first kernels (f32 only) do their arithmetic on the f32 CUDA cores
// (67 TFLOP/s, not the tensor cores' 989), and that is what bounds them: a
// forward at the train shape is 13 GFLOP, at least 0.19 ms there. They take
// any D that is a multiple of 16; at D = 256 the backward kernels stream
// 32-row tiles (BC), as 64 would need more than a block's shared memory, and
// at D = 512 the forward streams 16-key tiles and the backward kernels own
// 32 rows (R = 2 rows a thread group) and stream 16 (F32Cfg; each block
// ~200 KB). A block takes tile blockIdx.x % tiles of head blockIdx.x /
// tiles: gridDim.y would stop at 65535 heads.
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

constexpr int NT = 256;   // threads: 16 row groups (ty) x 16 lanes (tx)
constexpr float BIG_NEG = -1e30f;  // masked score, as _BIG_NEG in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Stage rows [row0, row0 + ROWS) of an [n, D] matrix into a [ROWS][D + 1]
// f32 tile. Rows at or past n are written as 0 and never read from memory.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int n) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
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
// (WRITE_LSE = true). One block per (q tile of 16 R rows, bh); online softmax
// over the k tiles of BC keys, as the TPU kernel does over its innermost grid
// axis.
template <typename T, int D, int R, int BC, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq_q, int seq_k, float scale) {
  constexpr int QR = 16 * R, LD = D + 1, LP = BC + 1, DC = D / 16, JN = BC / 16;
  extern __shared__ float smem[];
  float* qs = smem;           // [QR][LD]
  float* ks = qs + QR * LD;   // [BC][LD]
  float* vs = ks + BC * LD;   // [BC][LD]
  float* ps = vs + BC * LD;   // [QR][LP]

  const int n_qt = (seq_q + QR - 1) / QR, bh = blockIdx.x / n_qt, q0 = blockIdx.x % n_qt * QR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  o += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;

  load_tile<T, D, QR>(qs, q, q0, seq_q);

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (seq_k + BC - 1) / BC;
  if (CAUSAL) nk = min(nk, (q0 + QR - 1) / BC + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BC;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    load_tile<T, D, BC>(ks, k, k0, seq_k);
    load_tile<T, D, BC>(vs, v, k0, seq_k);
    __syncthreads();

    float s[R][JN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[R], b[JN];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = qs[(ty * R + i) * LD + d];
#pragma unroll
      for (int j = 0; j < JN; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
      bool ok[JN];
      float mc = BIG_NEG;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < seq_k && (!CAUSAL || qp >= kp);
        s[i][j] = ok[j] ? s[i][j] * scale : BIG_NEG;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mc));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps[(ty * R + i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = ps[(ty * R + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = vs[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
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
// (q tile of 16 R rows, bh); loops over k tiles of BC keys (F32Cfg). Per
// tile it re-derives p = exp(s - lse) and ds = p * (do.v^T - delta) * scale,
// then dq += ds.k.
template <typename T, int D, int R, int BC, bool CAUSAL>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int seq_q, int seq_k, float scale) {
  constexpr int QR = 16 * R, LD = D + 1, LP = BC + 1, DC = D / 16, JN = BC / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [QR][LD]
  float* dos = qs + QR * LD;    // [QR][LD]
  float* ks = dos + QR * LD;    // [BC][LD]
  float* vs = ks + BC * LD;     // [BC][LD]
  float* dss = vs + BC * LD;    // [QR][LP]

  const int n_qt = (seq_q + QR - 1) / QR, bh = blockIdx.x / n_qt, q0 = blockIdx.x % n_qt * QR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  dq += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  load_tile<T, D, QR>(qs, q, q0, seq_q);
  load_tile<T, D, QR>(dos, dout, q0, seq_q);

  float lr[R], dl[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    lr[i] = qp < seq_q ? lse[qp] : 0.f;
    dl[i] = qp < seq_q ? delta[qp] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (seq_k + BC - 1) / BC;
  if (CAUSAL) nk = min(nk, (q0 + QR - 1) / BC + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BC;
    __syncthreads();
    load_tile<T, D, BC>(ks, k, k0, seq_k);
    load_tile<T, D, BC>(vs, v, k0, seq_k);
    __syncthreads();

    float s[R][JN], dp[R][JN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], b[JN], w[JN];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty * R + i) * LD + d];
        g[i] = dos[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        b[j] = ks[(tx + 16 * j) * LD + d];
        w[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < seq_k && qp < seq_q && (!CAUSAL || qp >= kp);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty * R + i) * LP + tx + 16 * j] = ok ? p * (dp[i][j] - dl[i]) * scale : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dss[(ty * R + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float kv = ks[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][jj] = fmaf(ds[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    if (qp >= seq_q) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dq[static_cast<size_t>(qp) * D + tx + 16 * jj] = acc[i][jj];
  }
}

// ----------------------------------------------------------- backward dkv
// Replaces _attn_bwd_dkv_kernel. One block per (k tile of 16 R rows, bh);
// loops over the q tiles (of BC rows, F32Cfg) that can see it, so dk and dv
// need no atomics. The score tile is computed transposed (k rows x q
// columns) so that each thread's rows are the k rows whose dk and dv it
// accumulates.
template <typename T, int D, int R, int BC, bool CAUSAL>
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int seq_q, int seq_k, float scale) {
  constexpr int KR = 16 * R, LD = D + 1, LP = BC + 1, DC = D / 16, JN = BC / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // [KR][LD]
  float* vs = ks + KR * LD;     // [KR][LD]
  float* qs = vs + KR * LD;     // [BC][LD]
  float* dos = qs + BC * LD;    // [BC][LD]
  float* ps = dos + BC * LD;    // [KR][LP]  p transposed
  float* dss = ps + KR * LP;    // [KR][LP]  ds transposed
  float* ls = dss + KR * LP;    // [BC] lse of the q tile
  float* dls = ls + BC;         // [BC] delta of the q tile

  const int n_kt = (seq_k + KR - 1) / KR, bh = blockIdx.x / n_kt, k0 = blockIdx.x % n_kt * KR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += static_cast<size_t>(bh) * seq_q * D;
  dout += static_cast<size_t>(bh) * seq_q * D;
  k += static_cast<size_t>(bh) * seq_k * D;
  v += static_cast<size_t>(bh) * seq_k * D;
  dk += static_cast<size_t>(bh) * seq_k * D;
  dv += static_cast<size_t>(bh) * seq_k * D;
  lse += static_cast<size_t>(bh) * seq_q;
  delta += static_cast<size_t>(bh) * seq_q;

  load_tile<T, D, KR>(ks, k, k0, seq_k);
  load_tile<T, D, KR>(vs, v, k0, seq_k);

  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int nq = (seq_q + BC - 1) / BC;
  // The reference's skip: q tile qi sees k tile ki iff qi*bq + bq - 1 >= ki*bk.
  const int qt0 = CAUSAL ? k0 / BC : 0;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BC;
    __syncthreads();
    load_tile<T, D, BC>(qs, q, q0, seq_q);
    load_tile<T, D, BC>(dos, dout, q0, seq_q);
    if (threadIdx.x < BC) {
      const int qp = q0 + threadIdx.x;
      ls[threadIdx.x] = qp < seq_q ? lse[qp] : 0.f;
      dls[threadIdx.x] = qp < seq_q ? delta[qp] : 0.f;
    }
    __syncthreads();

    float s[R][JN], dp[R][JN];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], w[R], b[JN], g[JN];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = ks[(ty * R + i) * LD + d];
        w[i] = vs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        b[j] = qs[(tx + 16 * j) * LD + d];
        g[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kp = k0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int r = tx + 16 * j, qp = q0 + r;
        const bool ok = kp < seq_k && qp < seq_q && (!CAUSAL || qp >= kp);
        const float p = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
        ps[(ty * R + i) * LP + r] = p;
        dss[(ty * R + i) * LP + r] = ok ? p * (dp[i][j] - dls[r]) * scale : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float p[R], ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = ps[(ty * R + i) * LP + c];
        ds[i] = dss[(ty * R + i) * LP + c];
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float g = dos[c * LD + tx + 16 * jj];
        const float a = qs[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dva[i][jj] = fmaf(p[i], g, dva[i][jj]);
          dka[i][jj] = fmaf(ds[i], a, dka[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty * R + i;
    if (kp >= seq_k) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[static_cast<size_t>(kp) * D + tx + 16 * jj] = dka[i][jj];
      dv[static_cast<size_t>(kp) * D + tx + 16 * jj] = dva[i][jj];
    }
  }
}

// ===================================================== Hopper kernels (bf16)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, in the background; zero-filled when !valid, and
// then `src` is not read.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// One arrival on the barrier once this thread's cp.asyncs so far have
// landed; .noinc: the arrival is one of the barrier's expected count.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// As split_bf16x2, but hi = x with its low 16 bits cleared (bf16 rounded
// toward zero): one byte permute packs the pair, where rounding to nearest
// takes a conversion a pair, and conversions, not the products, set the
// backward's pace. x - hi is exact and below one bf16 ulp of x, so the
// error |x - hi - lo| stays under 2^-16 |x| (2^-17 with hi rounded to
// nearest).
__device__ __forceinline__ void split_bf16x2_trunc(float x, float y, uint32_t& hi, uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  asm("prmt.b32 %0, %1, %2, 0x7632;\n" : "=r"(hi) : "r"(xb), "r"(yb));
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __uint_as_float(xb & 0xFFFF0000u),
                                         y - __uint_as_float(yb & 0xFFFF0000u)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// How a bf16 tile of D columns lies in shared memory: a stack of boxes of BW
// columns as TMA writes them, [D / BW][rows][BW], each box row swizzled over
// its RB bytes. D a multiple of 64: 64-column boxes, 128-byte rows and the
// 128-byte swizzle. D = 96 (192 bytes a row, no swizzle's width): three
// 32-column boxes, 64-byte rows and the 64-byte swizzle. ATOM is the
// swizzle's period, 8 rows; a row holds KPB of wgmma's 16-column k steps.
template <int D>
struct Lay {
  static_assert(D % 64 == 0 || D == 96, "the Hopper kernels take D = 64, 96, 128, 256 or 512");
  static constexpr int BW = D % 64 == 0 ? 64 : 32;
  static constexpr int RB = 2 * BW;
  static constexpr int ATOM = 8 * RB;
  static constexpr int KPB = BW / 16;
  static constexpr uint64_t DESC_SWIZZLE = BW == 64 ? 1 : 2;  // wgmma descriptor: 128B, 64B
};

// The rows of a work item and how its two consumer warpgroups share it: up
// to D = 256, 128 rows, 64 a warpgroup; at D = 512 (COLS), 64 rows, both
// warpgroups on all of them, warpgroup w holding output columns [OUT w,
// OUT w + OUT) (see the file's header).
template <int D>
struct Items {
  static constexpr bool COLS = D == 512;
  static constexpr int ROWS = COLS ? 64 : FWD_BQ;
  static constexpr int OUT = COLS ? D / 2 : D;
  // A warpgroup's first row in the item and its first output column.
  __device__ static int row(int wg) { return COLS ? 0 : wg * 64; }
  __device__ static int col(int wg) { return COLS ? wg * OUT : 0; }
};

// Tile sizes and shared memory of one block, in bytes. At D = 128 a tile
// of 64 keys keeps S, P (hi and lo) and the output sums within the
// consumers' 240 registers; at D = 96, 128 keys do (0.3153 ms against
// 0.3261 for 64 at [128, 2048, 96] on an H100; Q plus the ring 216 KB). At
// D = 256 the output sums alone take 128 of them and Q 64 KB of shared
// memory: 32-key tiles in a ring of four stages (192 KB in all); 64-key
// tiles in two stages spilled and took 0.2221 ms against 0.2064 at
// [32, 2048, 256]. At D = 512, Q of the item's 64 rows 64 KB and 32-key
// tiles in two stages (192 KB in all).
template <int D>
struct FwdCfg {
  static constexpr int BN = D <= 96 ? 128 : D >= 256 ? 32 : 64;  // keys per K/V tile (the N of S = Q.K^T)
  static constexpr int STAGES = D == 512 ? 2 : 4;                // K/V ring depth
  static constexpr int Q_BYTES = Items<D>::ROWS * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  // + 1024: the dynamic base is aligned up to the swizzle's 1024-byte period.
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// The dynamic shared base aligned up to the 128-byte swizzle's 1024-byte
// period: the swizzle is a function of the shared address bits, so TMA and
// the wgmma descriptors agree on it only from a 1024-byte aligned base.
__device__ __forceinline__ bf16* swizzle_base(unsigned char* smem) {
  return reinterpret_cast<bf16*>(smem + (1024 - smem_u32(smem) % 1024) % 1024);
}

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

// One box [BW columns, `rows` rows, 1 head] of a 3-D [heads, rows, D] map at
// (column c0, row, head) into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(row), "r"(head)
      : "memory");
}
// Rows [row, row + ROWS) of head `head`, all D columns, one box per BW.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const CUtensorMap* map, uint32_t bar, int head,
                                          int row) {
  constexpr int BW = Lay<D>::BW;
#pragma unroll
  for (int c = 0; c < D / BW; ++c) tma_load_3d(dst + c * ROWS * BW, map, bar, c * BW, row, head);
}

// A wgmma shared-memory descriptor of an operand laid out as Lay<D>: start
// address, leading and stride byte offsets (in 16-byte units), and the
// swizzle (1 = 128B, 2 = 64B).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | Lay<D>::DESC_SWIZZLE << 62;
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
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(SCALE_D));
}
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}
// m64n128k16 RS into d[OFF, OFF + 64): 128 columns of a wider accumulator,
// laid out as wgmma lays out its first 128 (D = 256: OFF 0 and 64).
template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_at(float (&d)[M], const uint32_t (&a)[4], uint64_t b) {
  static_assert(OFF + 64 <= M, "the product's sums lie in d");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// wgmma_ss<0> with write-only sums: the compiler keeps no earlier value of
// d alive into the product, as the read-write operands of wgmma_ss make it
// do (the backward has no registers to spare for that at D = 128).
__device__ __forceinline__ void wgmma_ss_fresh(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_ss_fresh(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_ss_fresh(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_ss_fresh(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b));
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
// TRUNC (the backward's): split_bf16x2_trunc.
template <bool TRUNC = false, int N>
__device__ __forceinline__ void split_p(const float (&s)[N], uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (TRUNC)
        split_bf16x2_trunc(s[8 * c + 2 * r], s[8 * c + 2 * r + 1], hi[c][r], lo[c][r]);
      else
        split_bf16x2(s[8 * c + 2 * r], s[8 * c + 2 * r + 1], hi[c][r], lo[c][r]);
}

// S = Q.K^T of one tile: Q (this warpgroup's 64 rows at q_addr, in boxes of
// AROWS rows, an item's) and K (the stage's 2N rows at k_addr), both
// K-major, 16 columns of D per wgmma. Within a swizzled box row, the k-th 16
// columns start 32k bytes in. FRESH: the first product takes s as
// write-only (wgmma_ss_fresh).
template <int D, int AROWS, bool FRESH = false, int N>
__device__ __forceinline__ void issue_s(float (&s)[N], uint32_t q_addr, uint32_t k_addr) {
  using L = Lay<D>;
  // Each k step's descriptor is the tile's first plus its offset (16-byte
  // units, within the address field), made at each call: descriptors of a
  // resident operand (Q) held across the loop take registers the D = 256
  // kernels do not have.
  asm volatile("" : "+r"(q_addr), "+r"(k_addr));
  const uint64_t a0 = smem_desc<D>(q_addr, 16, L::ATOM), b0 = smem_desc<D>(k_addr, 16, L::ATOM);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int box = kc / L::KPB, at = kc % L::KPB * 32;
    const uint64_t a = a0 + ((box * AROWS * L::RB + at) >> 4);
    const uint64_t b = b0 + ((box * 2 * N * L::RB + at) >> 4);
    if (kc > 0)
      wgmma_ss<1>(s, a, b);
    else if (FRESH)
      wgmma_ss_fresh(s, a, b);
    else
      wgmma_ss<0>(s, a, b);
  }
}

// acc += P_hi.V + P_lo.V of one tile, 16 keys per wgmma pair. V is the
// MN-major B operand: 8 keys a swizzle atom (SBO), its boxes of BW columns
// 16 NC rows apart (LBO), NC groups of 16 keys. At D = 256 each pair is two
// products of 128 columns (boxes 0-1 into acc[0, 64), 2-3 into acc[64, 128)).
template <int D, int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p_hi)[NC][4],
                                         const uint32_t (&p_lo)[NC][4], uint32_t v_addr) {
  using L = Lay<D>;
  constexpr int BOX = 16 * NC * L::RB;
  asm volatile("" : "+r"(v_addr));  // as in issue_s
  const uint64_t b0 = smem_desc<D>(v_addr, BOX, L::ATOM);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint64_t b = b0 + ((c * 16 * L::RB) >> 4);
    if constexpr (D == 256) {
      const uint64_t b1 = b + ((2 * BOX) >> 4);
      wgmma_rs_at<0>(acc, p_hi[c], b);
      wgmma_rs_at<0>(acc, p_lo[c], b);
      wgmma_rs_at<64>(acc, p_hi[c], b1);
      wgmma_rs_at<64>(acc, p_lo[c], b1);
    } else {
      wgmma_rs(acc, p_hi[c], b);
      wgmma_rs(acc, p_lo[c], b);
    }
  }
}

#ifdef RT_TIMELINE
// Cycle stamps of block 0's two consumers (their thread 0) for each tile an
// item streams after its first, [kernel][consumer][tile][event]. Kernel 0 is
// the forward (events: 0 the tile's K and V landed, 1 S and the previous
// tile's P.V issued, 2 S in, 3 softmax done, 4 P.V in, 5 P split), 1 bwd_dq
// and 2 bwd_dkv (0 the tile landed, 1 S, dP and the previous tile's
// products issued, 2 S and dP in, 3 P and dS made, 4 the previous tile's
// products in, 5 split). Only ray_tpu_torch/ops/kernel_ab.py's timeline
// build defines RT_TIMELINE (chip_smoke.py phase 2 reads it through
// rt_timeline); the library the port loads has no stamps.
constexpr int TIMELINE_TILES = 64;
__device__ long long timeline[3][2][TIMELINE_TILES][6];
__device__ __forceinline__ void stamp(int kernel, int wg, int tile, int ev, bool pred) {
  long long* at = &timeline[kernel][wg][min(tile, TIMELINE_TILES - 1)][ev];
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b64 [%0], %1;\n}\n" ::"l"(at),
               "l"(clock64()), "r"(static_cast<int>(pred)) : "memory");
}
#define STAMP(kernel, tile, ev) stamp(kernel, wg, tile, ev, blockIdx.x == 0 && tid == 0)
#else
#define STAMP(kernel, tile, ev)
#endif

// K/V tiles a q tile of ROWS rows starting at row q0 takes: all of S, or
// with CAUSAL none above the diagonal.
template <bool CAUSAL, int BN, int ROWS>
__device__ __forceinline__ int kv_tiles(int q0, int seq_k) {
  const int n = (seq_k + BN - 1) / BN;
  return CAUSAL ? min(n, (q0 + ROWS - 1) / BN + 1) : n;
}

// Work comes in units of two ROWS-row tiles of one head (q tiles in the
// forward and in bwd_dq, k tiles in bwd_dkv), tile n_qt - 1 - p and tile p
// (the middle one alone when n_qt is odd), so causal units hold like work,
// and the blocks at work at one time share a few heads' streamed operands in
// L2. Item j of unit u: its head and first row; false past the unit's last.
template <int ROWS>
__device__ __forceinline__ bool unit_item(int u, int j, int n_qt, int& head, int& q0) {
  const int n_pairs = (n_qt + 1) / 2, p = u % n_pairs, qt = j == 0 ? n_qt - 1 - p : p;
  head = u / n_pairs;
  q0 = qt * ROWS;
  return j == 0 || qt != n_qt - 1 - p;
}

// Persistent: block b takes units b, b + gridDim.x, ... of the
// (n_qt + 1) / 2 * bh units. The K/V ring runs on across items, and the
// next item's Q loads while this item's last products and its stores run.
// At D = 512 both consumers take the item's rows and half its columns each
// (Items).
template <int D, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1) fwd_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse, int bh,
    int seq_q, int seq_k, float scale) {
  using Cfg = FwdCfg<D>;
  using It = Items<D>;
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES, ROWS = It::ROWS, OUT = It::OUT;
  extern __shared__ unsigned char fwd_smem[];
  bf16* qs = swizzle_base(fwd_smem);  // [D / 64][ROWS][64]
  bf16* ks = qs + ROWS * D;           // [STAGES][D / 64][BN][64]
  bf16* vs = ks + STAGES * BN * D;  // [STAGES][D / 64][BN][64]
  const uint32_t q_full = smem_u32(vs + STAGES * BN * D);  // the item's Q landed
  const uint32_t q_empty = q_full + 8;                     // both consumers are done with Q
  const uint32_t full_bar = q_empty + 8;                   // [STAGES]: the stage's K and V landed
  const uint32_t empty_bar = full_bar + 8 * STAGES;        // [STAGES]: both consumers are done with it

  const int n_qt = (seq_q + ROWS - 1) / ROWS, n_units = (n_qt + 1) / 2 * bh;
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
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          mbar_wait(q_empty, (n & 1) ^ 1);  // passes at once for the first item
          mbar_expect_tx(q_full, Cfg::Q_BYTES);
          load_rows<ROWS, D>(qs, &q_map, q_full, head, q0);
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
  } else {  // consumer warpgroup wg: q rows [q0 + row(wg), + 64) of each item, columns [col(wg), + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(qs) + It::row(wg) * Lay<D>::RB;
    // This warpgroup's output columns of a V stage: its boxes, BN rows each.
    const uint32_t v_at = It::col(wg) / Lay<D>::BW * BN * Lay<D>::RB;
    float s[BN / 2], acc[OUT / 2], alpha[2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];

    int it = 0, n = 0, head, q0;  // K/V tiles and items consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
        const int row0 = q0 + It::row(wg);
        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) acc[i] = 0.f;
        float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};  // l: this thread's part of the row sum

        mbar_wait(q_full, n & 1);
        bar_arrive_if(1, wg == 1);  // warpgroup 0 issues first
        // Tile 0: S_0 alone.
        mbar_wait(full_bar + 8 * (it % STAGES), it / STAGES & 1);
        bar_sync(1 + wg);
        keep(s);
        wgmma_fence();
        issue_s<D, ROWS>(s, q_addr, smem_u32(ks + it % STAGES * BN * D));
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
          STAMP(0, it + kt, 0);
          bar_sync(1 + wg);
          keep(s);
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          wgmma_fence();
          issue_s<D, ROWS>(s, q_addr, smem_u32(ks + st * BN * D));
          wgmma_commit();
          issue_pv<OUT>(acc, p_hi, p_lo, smem_u32(vs + prev * BN * D) + v_at);
          wgmma_commit();
          STAMP(0, it + kt, 1);
          keep(s);
          keep(acc);
          bar_arrive_if(2 - wg, wg == 0 || kt + 1 < n_kv_tiles);
          wgmma_wait<1>();  // S_kt is in
          keep(s);
          STAMP(0, it + kt, 2);
          mbar_arrive_if(q_empty, tid == 0 && kt + 1 == n_kv_tiles);
          softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN, row0, r0, tg, seq_k, sl2);
          STAMP(0, it + kt, 3);
          wgmma_wait<0>();  // P_{kt-1}.V_{kt-1} is in: its P and its stage are free
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          STAMP(0, it + kt, 4);
          mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
#pragma unroll
          for (int i = 0; i < OUT / 2; ++i) acc[i] *= alpha[i % 4 / 2];
          split_p(s, p_hi, p_lo);
          STAMP(0, it + kt, 5);
        }
        it += n_kv_tiles;
        const int last = (it - 1) % STAGES;
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        wgmma_fence();
        issue_pv<OUT>(acc, p_hi, p_lo, smem_u32(vs + last * BN * D) + v_at);
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
          bf16* orow = o + (static_cast<size_t>(head) * seq_q + qp) * D + It::col(wg);
#pragma unroll
          for (int c = 0; c < OUT / 8; ++c)
            *reinterpret_cast<__nv_bfloat162*>(orow + c * 8 + 2 * tg) =
                __floats2bfloat162_rn(acc[4 * c + 2 * r] * linv, acc[4 * c + 2 * r + 1] * linv);
          // With COLS both warpgroups hold the row's m and l: warpgroup 0 writes lse.
          if (WRITE_LSE && tg == 0 && It::col(wg) == 0)
            lse[static_cast<size_t>(head) * seq_q + qp] = m[r] * LN2 + logf(lsafe);
        }
      }
  }
}

// ============================================= backward on Hopper (bf16, sm_90a)
//
// bwd_dkv_kernel_sm90 replaces _attn_bwd_dkv_kernel (B4) and
// bwd_dq_kernel_sm90 _attn_bwd_dq_kernel (B3) of
// ray_tpu/ops/flash_attention.py for bf16 inputs, with the tile math of its
// _bwd_tile. See the file's header for what bounds them and why they are
// built this way. Both use the forward's layout, producer and wgmma parts;
// neither uses an atomic, so every sum is taken in one order on every run.

// bwd_dkv: 128 k rows an item (64 per consumer warpgroup; at D = 512, 64
// rows for both, Items), K and V loaded once an item; Q, dO, lse and delta
// stream in tiles of BQ q rows.
template <int D>
struct DkvCfg {
  // q rows per tile (the N of S^T = K.Q^T). At D = 128, dK and dV take 128
  // of a consumer thread's 240 registers, and a 64-row tile's S^T, dP^T and
  // their split operands (64 more) left ptxas spilling; D = 96 takes 128's
  // 32-row tiles. At 512, 16-row tiles: K and V of the item take 128 KB.
  static constexpr int BQ = D == 64 ? 64 : D == 512 ? 16 : 32;
  // At D = 256, dK and dV would take 256 registers a thread: the consumers
  // make them in two passes over the item's q tiles, 128 columns each
  // (DA), and recompute S^T and dP^T in the second (K, V 128 KB for the
  // item, Q and dO tiles 32 KB a stage). At 512 each warpgroup's 256
  // columns (Items::OUT) take the same two passes.
  static constexpr int PASSES = D >= 256 ? 2 : 1;
  static constexpr int DA = Items<D>::OUT / PASSES;
  static constexpr int STAGES = D >= 256 ? 3 : 4;
  // Tile t's S^T and dP^T beside tile t-1's split operands, which dK and dV
  // at D = 128 and up leave no room for (at 96 0.5116 ms against 0.6261 in
  // turn at [128, 2048, 96] on an H100).
  static constexpr bool PIPE = D <= 96;
  static constexpr int KV_BYTES = Items<D>::ROWS * D * 2;  // an item's K or V
  static constexpr int QT_BYTES = BQ * D * 2;      // one Q or dO tile
  static constexpr int STAT_BYTES = 2 * BQ * 4;    // one tile's lse and delta
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 2 * KV_BYTES + STAGES * (2 * QT_BYTES + STAT_BYTES) + BAR_BYTES + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// bwd_dq: 128 q rows an item (64 at D = 512, Items), Q and dO loaded once an
// item; K and V stream in tiles of BN keys, as in the forward.
template <int D>
struct DqCfg {
  // Keys per K/V tile: S and dP of tile kt beside tile kt-1's split dS, in
  // the consumers' registers. At D = 256 an item's Q and dO take 128 KB:
  // 32-key tiles, three stages (224 KB in all); at 512 they take 128 KB for
  // 64 rows: 16-key tiles, three stages (224 KB).
  static constexpr int BN = D == 512 ? 16 : D == 256 ? 32 : 64;
  static constexpr int STAGES = D >= 256 ? 3 : 4;
  static constexpr int Q_BYTES = Items<D>::ROWS * D * 2;  // an item's Q or dO
  static constexpr int KV_BYTES = BN * D * 2;     // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// P^T = exp(S^T * scale - lse) and dS^T / scale = P^T (dP^T - delta) of one
// tile (k rows x q columns) in place of S^T in s and dP^T in dp, 0 where
// masked (MASK); the scale is taken once, on dK, when the item ends. The q
// columns' lse and delta come from the stage's shared slots `stat` ([lse |
// delta], BQ each); this thread's accumulator column group j holds columns
// 8j + 2tg and 8j + 2tg + 1 of rows r0 and r0 + 8. exp2 with scale *
// log2(e) folded into one FMA, as in the forward.
template <bool MASK, bool CAUSAL, int N>
__device__ __forceinline__ void dkv_grads(float (&s)[N], float (&dp)[N], const float* stat, int q0,
                                          int r0, int tg, int seq_q, int seq_k, float sl2) {
  constexpr int BQ = 2 * N;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * tg);
    const float2 d = *reinterpret_cast<const float2*>(stat + BQ + 8 * j + 2 * tg);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, qp = q0 + 8 * j + 2 * tg + e % 2, kp = r0 + 8 * (e / 2);
      const bool ok = !MASK || (qp < seq_q && kp < seq_k && (!CAUSAL || qp >= kp));
      const float p = ex2(fmaf(s[i], sl2, -(e % 2 ? l.y : l.x) * LOG2E));
      s[i] = ok ? p : 0.f;
      dp[i] = ok ? p * (dp[i] - (e % 2 ? d.y : d.x)) : 0.f;
    }
  }
}

// P = exp(S * scale - lse) and dS / scale = P (dP - delta) of one tile (q
// rows x keys) in place of dP in dp, 0 where masked (MASK; the scale is
// taken once, on dQ, when the item ends); lse2 = lse * log2(e) and dl =
// delta of this thread's rows r0 and r0 + 8; c0 is the key of s[0]. Rows
// past T are not masked: a dq row depends on its own dS row only, and
// those rows are not written.
template <bool MASK, bool CAUSAL, int N>
__device__ __forceinline__ void dq_grads(const float (&s)[N], float (&dp)[N], const float (&lse2)[2],
                                         const float (&dl)[2], int r0, int c0, int seq_k, float sl2) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = i % 4 / 2, qp = r0 + 8 * r, kp = c0 + 8 * (i / 4) + i % 2;
    const bool ok = !MASK || (kp < seq_k && (!CAUSAL || qp >= kp));
    const float p = ex2(fmaf(s[i], sl2, -lse2[r]));
    dp[i] = ok ? p * (dp[i] - dl[r]) : 0.f;
  }
}

// This thread's rows r0 and r0 + 8 of a 64-row f32 accumulator of DA
// columns (DA / 8 column groups of 8, as wgmma lays them out) into rows of
// `out`, ld floats apart, up to n.
template <int DA>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[DA / 2], int r0, int tg, int n,
                                           int ld) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < DA / 8; ++c)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * ld + c * 8 + 2 * tg) =
          make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
}

// Persistent, in units of two 128-row k tiles (unit_item). Per item the
// producer loads K and V once, then streams the Q and dO tiles of the q
// tiles that see it (with CAUSAL from q0 = k0: the reference's skip, q tile
// qi sees k tile ki iff qi*bq + bq - 1 >= ki*bk) with their lse and delta.
// A consumer warpgroup owns 64 k rows: per q tile S^T = K.Q^T and dP^T =
// V.dO^T (SS), P^T and dS^T in registers, then dV += P^T_hi.dO + P^T_lo.dO
// and dK += dS^T_hi.Q + dS^T_lo.Q (RS, dO and Q MN-major); dK and dV stay
// in registers until the item ends.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dkv_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int bh, int seq_q, int seq_k, float scale) {
  using Cfg = DkvCfg<D>;
  using It = Items<D>;
  constexpr int BQ = Cfg::BQ, STAGES = Cfg::STAGES, DA = Cfg::DA, ROWS = It::ROWS;
  extern __shared__ unsigned char dkv_smem[];
  bf16* ks = swizzle_base(dkv_smem);  // [D / 64][ROWS][64]
  bf16* vs = ks + ROWS * D;           // [D / 64][ROWS][64]
  bf16* qs = vs + ROWS * D;           // [STAGES][D / 64][BQ][64]
  bf16* dos = qs + STAGES * BQ * D;   // [STAGES][D / 64][BQ][64]
  float* stats = reinterpret_cast<float*>(dos + STAGES * BQ * D);  // [STAGES][lse | delta][BQ]
  const uint32_t kv_full = smem_u32(stats + STAGES * 2 * BQ);  // the item's K and V landed
  const uint32_t kv_empty = kv_full + 8;                       // both consumers are done with them
  const uint32_t full_bar = kv_empty + 8;                      // [STAGES]: the stage's tiles and stats landed
  const uint32_t empty_bar = full_bar + 8 * STAGES;            // [STAGES]: both consumers are done with it

  const int n_kt = (seq_k + ROWS - 1) / ROWS, n_units = (n_kt + 1) / 2 * bh;
  const int n_qt = (seq_q + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1 + 32);  // the TMA's arrival and one per producer lane's cp.asyncs
      mbar_init(empty_bar + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one warp; lane 0 issues the TMA loads, every lane copies stats
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      int it = 0, n = 0, head, k0;  // Q/dO tiles (the ring's position) and items loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_kt, head, k0); ++j, ++n) {
          mbar_wait(kv_empty, (n & 1) ^ 1);  // passes at once for the first item
          if (lane == 0) {
            mbar_expect_tx(kv_full, 2 * Cfg::KV_BYTES);
            load_rows<ROWS, D>(ks, &k_map, kv_full, head, k0);
            load_rows<ROWS, D>(vs, &v_map, kv_full, head, k0);
          }
          const float* lse_h = lse + static_cast<size_t>(head) * seq_q;
          const float* delta_h = delta + static_cast<size_t>(head) * seq_q;
          for (int pass = 0; pass < Cfg::PASSES; ++pass)
            for (int qt = CAUSAL ? k0 / BQ : 0; qt < n_qt; ++qt, ++it) {
              const int st = it % STAGES;
              const uint32_t full = full_bar + 8 * st;
              mbar_wait(empty_bar + 8 * st, (it / STAGES & 1) ^ 1);  // passes at once on the first lap
              if (lane == 0) {
                mbar_expect_tx(full, 2 * Cfg::QT_BYTES);  // rows past T are zero-filled and counted
                load_rows<BQ, D>(qs + st * BQ * D, &q_map, full, head, qt * BQ);
                load_rows<BQ, D>(dos + st * BQ * D, &do_map, full, head, qt * BQ);
              }
              // lse and delta rows are 4 * T bytes apart, no multiple of 16 for
              // every T, so they come by cp.async, zero-filled past T (a
              // lane past BQ copies nothing and still arrives).
              float* stat = stats + st * 2 * BQ;
#pragma unroll
              for (int c = 0; c < (BQ + 31) / 32; ++c) {
                const int i = lane + 32 * c, qp = qt * BQ + i;
                const bool in = qp < seq_q;
                if (i < BQ) {
                  cp_async_4(stat + i, lse_h + (in ? qp : 0), in);
                  cp_async_4(stat + BQ + i, delta_h + (in ? qp : 0), in);
                }
              }
              cp_async_arrive(full);
            }
        }
    }
  } else {  // consumer warpgroup wg: k rows [k0 + row(wg), + 64) of each item, columns [col(wg), + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t k_addr = smem_u32(ks) + It::row(wg) * Lay<D>::RB;
    const uint32_t v_addr = smem_u32(vs) + It::row(wg) * Lay<D>::RB;
    float s[BQ / 2], dp[BQ / 2], dka[DA / 2], dva[DA / 2];
    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
    auto q_addr = [&](int st) { return smem_u32(qs + st * BQ * D); };
    auto do_addr = [&](int st) { return smem_u32(dos + st * BQ * D); };
    auto keep_split = [&] {
      keep(p_hi);
      keep(p_lo);
      keep(ds_hi);
      keep(ds_lo);
    };
    // S^T = K.Q^T and dP^T = V.dO^T of the tile in stage st, issued.
    auto issue_sdp = [&](int st) {
      issue_s<D, ROWS, true>(s, k_addr, q_addr(st));
      issue_s<D, ROWS, true>(dp, v_addr, do_addr(st));
    };
    // The DA columns a pass makes: this warpgroup's columns, in passes.
    auto chunk = [&](int pass) { return It::col(wg) / DA + pass; };
    // dV += P^T.dO and dK += dS^T.Q of the tile in stage st, issued: the
    // DA columns of pass `pass` (dO's and Q's boxes from its first).
    auto issue_dkv = [&](int st, int pass) {
      const uint32_t at = chunk(pass) * (DA / Lay<D>::BW) * BQ * Lay<D>::RB;
      issue_pv<DA>(dva, p_hi, p_lo, do_addr(st) + at);
      issue_pv<DA>(dka, ds_hi, ds_lo, q_addr(st) + at);
    };
    // P^T and dS^T of the tile at q0 (stage st) in place of S^T and dP^T.
    // Only a tile that crosses the diagonal or the end of T or S has masked
    // entries.
    auto grads = [&](int st, int q0, int row0, int r0) {
      const float* stat = stats + st * 2 * BQ;
      if (q0 + BQ > seq_q || row0 + 64 > seq_k || (CAUSAL && q0 < row0 + 63))
        dkv_grads<true, CAUSAL>(s, dp, stat, q0, r0, tg, seq_q, seq_k, sl2);
      else
        dkv_grads<false, CAUSAL>(s, dp, stat, q0, r0, tg, seq_q, seq_k, sl2);
    };
    auto split = [&] {
      split_p<true>(s, p_hi, p_lo);
      split_p<true>(dp, ds_hi, ds_lo);
    };

    int it = 0, n = 0, head, k0;  // Q/dO tiles and items consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_kt, head, k0); ++j, ++n) {
        const int row0 = k0 + It::row(wg);
        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's k rows: r0 and r0 + 8
        const int qt0 = CAUSAL ? k0 / BQ : 0, n_t = max(n_qt - qt0, 0);
        mbar_wait(kv_full, n & 1);
        // With CAUSAL, the item's first q tiles up to row0 lie wholly above
        // this warpgroup's rows (warpgroup 1's first 64 q rows): it waits for
        // each and frees its stage, and adds nothing.
        const int t0 = min(CAUSAL ? It::row(wg) / BQ : 0, n_t);
        const size_t at = static_cast<size_t>(head) * seq_k * D;
        for (int pass = 0; pass < Cfg::PASSES; ++pass) {
          const bool last = pass + 1 == Cfg::PASSES;  // K and V may go after its last S^T
#pragma unroll
          for (int i = 0; i < DA / 2; ++i) dka[i] = dva[i] = 0.f;
          for (int t = 0; t < t0; ++t) {
            const int st = (it + t) % STAGES;
            mbar_wait(full_bar + 8 * st, (it + t) / STAGES & 1);
            mbar_arrive_if(empty_bar + 8 * st, tid == 0);
          }
          if constexpr (Cfg::PIPE) {
            if (t0 < n_t) {
              // Tile t's S^T and dP^T are issued with tile t-1's dK and dV
              // products, so tile t's P^T and dS^T are made while the tensor
              // cores run tile t-1's.
              int st = (it + t0) % STAGES;
              mbar_wait(full_bar + 8 * st, (it + t0) / STAGES & 1);
              wgmma_fence();
              issue_sdp(st);
              wgmma_commit();
              keep(s);
              keep(dp);
              wgmma_wait<0>();
              keep(s);
              keep(dp);
              mbar_arrive_if(kv_empty, tid == 0 && last && t0 + 1 == n_t);  // the last S^T: K and V may go
              grads(st, (qt0 + t0) * BQ, row0, r0);
              split();
              for (int t = t0 + 1; t < n_t; ++t) {
                const int prev = st;
                st = (it + t) % STAGES;
                mbar_wait(full_bar + 8 * st, (it + t) / STAGES & 1);
                STAMP(2, it + t, 0);
                keep(dka);
                keep(dva);
                keep_split();
                wgmma_fence();
                issue_sdp(st);
                wgmma_commit();
                issue_dkv(prev, pass);
                wgmma_commit();
                keep(s);
                keep(dp);
                keep(dka);
                keep(dva);
                STAMP(2, it + t, 1);
                wgmma_wait<1>();  // S^T and dP^T of tile t are in
                keep(s);
                keep(dp);
                STAMP(2, it + t, 2);
                mbar_arrive_if(kv_empty, tid == 0 && last && t + 1 == n_t);
                grads(st, (qt0 + t) * BQ, row0, r0);
                STAMP(2, it + t, 3);
                wgmma_wait<0>();  // tile t-1's products are in: its stage and its split are free
                keep(dka);
                keep(dva);
                keep_split();
                STAMP(2, it + t, 4);
                mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
                split();
                STAMP(2, it + t, 5);
              }
              keep(dka);
              keep(dva);
              keep_split();
              wgmma_fence();
              issue_dkv(st, pass);
              wgmma_commit();
              keep(dka);
              keep(dva);
              wgmma_wait<0>();
              keep(dka);
              keep(dva);
              keep_split();
              mbar_arrive_if(empty_bar + 8 * st, tid == 0);
            }
          } else {
            // Without the registers to hold two tiles' operands (D = 128 and
            // up): each tile's products in turn.
            for (int t = t0; t < n_t; ++t) {
              const int st = (it + t) % STAGES;
              mbar_wait(full_bar + 8 * st, (it + t) / STAGES & 1);
              wgmma_fence();
              issue_sdp(st);
              wgmma_commit();
              keep(s);
              keep(dp);
              wgmma_wait<0>();
              keep(s);
              keep(dp);
              mbar_arrive_if(kv_empty, tid == 0 && last && t + 1 == n_t);
              grads(st, (qt0 + t) * BQ, row0, r0);
              split();
              keep(dka);
              keep(dva);
              keep_split();
              wgmma_fence();
              issue_dkv(st, pass);
              wgmma_commit();
              keep(dka);
              keep(dva);
              wgmma_wait<0>();
              keep(dka);
              keep(dva);
              keep_split();
              mbar_arrive_if(empty_bar + 8 * st, tid == 0);
            }
          }
          it += n_t;
#pragma unroll
          for (int i = 0; i < DA / 2; ++i) dka[i] *= scale;
          store_rows<DA>(dk + at + chunk(pass) * DA, dka, r0, tg, seq_k, D);
          store_rows<DA>(dv + at + chunk(pass) * DA, dva, r0, tg, seq_k, D);
        }
        mbar_arrive_if(kv_empty, tid == 0 && t0 >= n_t);  // no q tile of the item sees these rows
      }
  }
}

// Persistent, in the forward's units of two 128-row q tiles. Per item the
// producer loads Q and dO once, then streams the K and V tiles up to the
// diagonal (kv_tiles). A consumer warpgroup owns 64 q rows: per K/V tile
// S = Q.K^T and dP = dO.V^T (SS), P and dS in registers (lse is known:
// nothing is rescaled), then dQ += dS_hi.K + dS_lo.K (RS, K MN-major, as V
// in the forward's P.V).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dq_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int bh,
    int seq_q, int seq_k, float scale) {
  using Cfg = DqCfg<D>;
  using It = Items<D>;
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES, ROWS = It::ROWS, OUT = It::OUT;
  extern __shared__ unsigned char dq_smem[];
  bf16* qs = swizzle_base(dq_smem);   // [D / 64][ROWS][64]
  bf16* dos = qs + ROWS * D;          // [D / 64][ROWS][64]
  bf16* ks = dos + ROWS * D;          // [STAGES][D / 64][BN][64]
  bf16* vs = ks + STAGES * BN * D;    // [STAGES][D / 64][BN][64]
  const uint32_t qdo_full = smem_u32(vs + STAGES * BN * D);  // the item's Q and dO landed
  const uint32_t qdo_empty = qdo_full + 8;                     // both consumers are done with them
  const uint32_t full_bar = qdo_empty + 8;                   // [STAGES]: the stage's K and V landed
  const uint32_t empty_bar = full_bar + 8 * STAGES;        // [STAGES]: both consumers are done with it

  const int n_qt = (seq_q + ROWS - 1) / ROWS, n_units = (n_qt + 1) / 2 * bh;
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    mbar_init(qdo_empty, 2);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one thread keeps Q, dO and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int it = 0, n = 0, head, q0;  // K/V tiles (the ring's position) and items loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          mbar_wait(qdo_empty, (n & 1) ^ 1);  // passes at once for the first item
          mbar_expect_tx(qdo_full, 2 * Cfg::Q_BYTES);
          load_rows<ROWS, D>(qs, &q_map, qdo_full, head, q0);
          load_rows<ROWS, D>(dos, &do_map, qdo_full, head, q0);
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++it) {
            const int st = it % STAGES;
            mbar_wait(empty_bar + 8 * st, (it / STAGES & 1) ^ 1);  // passes at once on the first lap
            const uint32_t ring_full = full_bar + 8 * st;
            mbar_expect_tx(ring_full, 2 * Cfg::KV_BYTES);  // out-of-range rows are zero-filled and counted
            load_rows<BN, D>(ks + st * BN * D, &k_map, ring_full, head, kt * BN);
            load_rows<BN, D>(vs + st * BN * D, &v_map, ring_full, head, kt * BN);
          }
        }
    }
  } else {  // consumer warpgroup wg: q rows [q0 + row(wg), + 64) of each item, columns [col(wg), + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(qs) + It::row(wg) * Lay<D>::RB;
    const uint32_t do_addr = smem_u32(dos) + It::row(wg) * Lay<D>::RB;
    // This warpgroup's dQ columns of a K stage: its boxes, BN rows each.
    const uint32_t k_at = It::col(wg) / Lay<D>::BW * BN * Lay<D>::RB;
    float s[BN / 2], dp[BN / 2], dqa[OUT / 2];
    uint32_t ds_hi[BN / 16][4], ds_lo[BN / 16][4];
    auto k_addr = [&](int st) { return smem_u32(ks + st * BN * D); };
    // S = Q.K^T and dP = dO.V^T of the tile in stage st, issued.
    auto issue_sdp = [&](int st) {
      issue_s<D, ROWS, true>(s, q_addr, k_addr(st));
      issue_s<D, ROWS, true>(dp, do_addr, smem_u32(vs + st * BN * D));
    };

    int it = 0, n = 0, head, q0;  // K/V tiles and items consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
        const int row0 = q0 + It::row(wg);
        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
        float lse2[2], dl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r;
          const size_t at = static_cast<size_t>(head) * seq_q + qp;
          lse2[r] = qp < seq_q ? lse[at] * LOG2E : 0.f;
          dl[r] = qp < seq_q ? delta[at] : 0.f;
        }
        // dS of the tile at k0 in place of dP, split into hi and lo. Only a
        // tile on the diagonal or past seq_k has masked entries.
        auto grads = [&](int k0) {
          if (k0 + BN > seq_k || (CAUSAL && k0 + BN - 1 > row0))
            dq_grads<true, CAUSAL>(s, dp, lse2, dl, r0, k0 + 2 * tg, seq_k, sl2);
          else
            dq_grads<false, CAUSAL>(s, dp, lse2, dl, r0, k0 + 2 * tg, seq_k, sl2);
        };
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dqa[i] = 0.f;
        mbar_wait(qdo_full, n & 1);
        // As the forward: tile kt's S and dP are issued with tile kt-1's dQ
        // product and the consumers issue in turn, so tile kt's dS is made
        // while the tensor cores run tile kt-1's.
        bar_arrive_if(1, wg == 1);  // warpgroup 0 issues first
        int st = it % STAGES;
        mbar_wait(full_bar + 8 * st, it / STAGES & 1);
        bar_sync(1 + wg);
        wgmma_fence();
        issue_sdp(st);
        wgmma_commit();
        keep(s);
        keep(dp);
        bar_arrive_if(2 - wg, wg == 0 || n_kv_tiles > 1);  // the other warpgroup's turn
        wgmma_wait<0>();
        keep(s);
        keep(dp);
        mbar_arrive_if(qdo_empty, tid == 0 && n_kv_tiles == 1);  // the item's last S: Q and dO may go
        grads(0);
        split_p<true>(dp, ds_hi, ds_lo);
        for (int kt = 1; kt < n_kv_tiles; ++kt) {
          const int prev = st;
          st = (it + kt) % STAGES;
          mbar_wait(full_bar + 8 * st, (it + kt) / STAGES & 1);
          STAMP(1, it + kt, 0);
          bar_sync(1 + wg);
          keep(dqa);
          keep(ds_hi);
          keep(ds_lo);
          wgmma_fence();
          issue_sdp(st);
          wgmma_commit();
          issue_pv<OUT>(dqa, ds_hi, ds_lo, k_addr(prev) + k_at);  // dQ += dS.K
          wgmma_commit();
          keep(s);
          keep(dp);
          keep(dqa);
          STAMP(1, it + kt, 1);
          bar_arrive_if(2 - wg, wg == 0 || kt + 1 < n_kv_tiles);
          wgmma_wait<1>();  // S and dP of tile kt are in
          keep(s);
          keep(dp);
          STAMP(1, it + kt, 2);
          mbar_arrive_if(qdo_empty, tid == 0 && kt + 1 == n_kv_tiles);
          grads(kt * BN);
          STAMP(1, it + kt, 3);
          wgmma_wait<0>();  // tile kt-1's product is in: its stage and its split are free
          keep(dqa);
          keep(ds_hi);
          keep(ds_lo);
          STAMP(1, it + kt, 4);
          mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
          split_p<true>(dp, ds_hi, ds_lo);
          STAMP(1, it + kt, 5);
        }
        it += n_kv_tiles;
        keep(dqa);
        keep(ds_hi);
        keep(ds_lo);
        wgmma_fence();
        issue_pv<OUT>(dqa, ds_hi, ds_lo, k_addr(st) + k_at);
        wgmma_commit();
        keep(dqa);
        wgmma_wait<0>();
        keep(dqa);
        keep(ds_hi);
        keep(ds_lo);
        mbar_arrive_if(empty_bar + 8 * st, tid == 0);
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dqa[i] *= scale;
        store_rows<OUT>(dq + static_cast<size_t>(head) * seq_q * D + It::col(wg), dqa, r0, tg, seq_q, D);
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

// The f32 kernels' tiles by head dim: R rows a thread group (16 R rows a
// block) and BC rows a streamed tile. Up to 256 the forward takes 64 q rows
// and 64-key tiles, and the backward 64 rows and 64-row tiles (32 past 128);
// at 512 the forward 16-key tiles and the backward 32 rows and 16-row tiles,
// so each block fits in 227 KB.
template <int D>
struct F32Cfg {
  static constexpr int FWD_R = 4, FWD_BC = D == 512 ? 16 : 64;
  static constexpr int BWD_R = D == 512 ? 2 : 4, BWD_BC = D == 512 ? 16 : D > 128 ? 32 : 64;
};

// A block per tile of `rows` rows (16 r a tile) of each of bh heads, in
// gridDim.x, which takes up to 2^31 - 1 blocks.
cudaError_t head_grid(int rows, int r, int bh, dim3& grid) {
  const long long blocks = static_cast<long long>((rows + 16 * r - 1) / (16 * r)) * bh;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  constexpr int R = F32Cfg<D>::FWD_R, BC = F32Cfg<D>::FWD_BC, QR = 16 * R;
  constexpr size_t smem = sizeof(float) * (QR * (D + 1) + 2 * BC * (D + 1) + QR * (BC + 1));
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  dim3 grid;
  const cudaError_t err = head_grid(seq_q, R, bh, grid);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (causal) {
    return lse ? launch<fwd_kernel<T, D, R, BC, true, true>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                             seq_q, seq_k, scale)
               : launch<fwd_kernel<T, D, R, BC, true, false>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                              seq_q, seq_k, scale);
  }
  return lse ? launch<fwd_kernel<T, D, R, BC, false, true>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                            seq_q, seq_k, scale)
             : launch<fwd_kernel<T, D, R, BC, false, false>>(grid, smem, stream, qt, kt, vt, ot, lse,
                                                             seq_q, seq_k, scale);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, float* dq, int bh, int seq_q, int seq_k,
                   float scale, bool causal, cudaStream_t stream) {
  constexpr int R = F32Cfg<D>::BWD_R, BC = F32Cfg<D>::BWD_BC, QR = 16 * R;
  constexpr size_t smem = sizeof(float) * (2 * QR * (D + 1) + 2 * BC * (D + 1) + QR * (BC + 1));
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  dim3 grid;
  const cudaError_t err = head_grid(seq_q, R, bh, grid);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  return causal ? launch<bwd_dq_kernel<T, D, R, BC, true>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                           delta, dq, seq_q, seq_k, scale)
                : launch<bwd_dq_kernel<T, D, R, BC, false>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                            delta, dq, seq_q, seq_k, scale);
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, float* dk, float* dv, int bh,
                    int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  constexpr int R = F32Cfg<D>::BWD_R, BC = F32Cfg<D>::BWD_BC, KR = 16 * R;
  constexpr size_t smem =
      sizeof(float) * (2 * KR * (D + 1) + 2 * BC * (D + 1) + 2 * KR * (BC + 1) + 2 * BC);
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  dim3 grid;
  const cudaError_t err = head_grid(seq_k, R, bh, grid);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  return causal ? launch<bwd_dkv_kernel<T, D, R, BC, true>>(grid, smem, stream, qt, kt, vt, dot, lse,
                                                            delta, dk, dv, seq_q, seq_k, scale)
                : launch<bwd_dkv_kernel<T, D, R, BC, false>>(grid, smem, stream, qt, kt, vt, dot, lse,
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
// Lay<D>::BW columns by box_rows rows of one head, swizzled over a box row's
// bytes (Lay<D>). A box's rows past `rows` are zero-filled: they never come
// from the next head. TMA needs the base 16-byte aligned and every stride a
// multiple of 16 bytes: the wrapper checks the first, and D in {64, 96,
// 128, 256, 512} gives the second.
template <int D>
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int heads, int rows, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {Lay<D>::BW, cuuint32_t(box_rows), 1}, unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = Lay<D>::BW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks for a persistent kernel of `units` units of work: one per SM, or
// one per unit if there are fewer.
cudaError_t persistent_grid(int units, dim3& grid) {
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  grid = dim3(min(units, sm_count[dev]));
  return cudaSuccess;
}

// Units of two ROWS-row tiles (unit_item) over `rows` rows of each of bh
// heads; the kernels count units in int.
template <int ROWS>
cudaError_t units_of(int rows, int bh, int& units) {
  const long long n = static_cast<long long>(((rows + ROWS - 1) / ROWS + 1) / 2) * bh;
  if (n > 0x7FFFFFFF) return cudaErrorInvalidValue;
  units = static_cast<int>(n);
  return cudaSuccess;
}

template <int D>
cudaError_t fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                     int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  constexpr int ROWS = Items<D>::ROWS;
  CUtensorMap qm, km, vm;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, bh, seq_q, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, bh, seq_k, FwdCfg<D>::BN);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, bh, seq_k, FwdCfg<D>::BN);
  if (err == cudaSuccess) err = units_of<ROWS>(seq_q, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdCfg<D>::BYTES;
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
cudaError_t bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* dk, float* dv, int bh,
                         int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  constexpr int ROWS = Items<D>::ROWS;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, bh, seq_q, DkvCfg<D>::BQ);
  if (err == cudaSuccess) err = encode_rows<D>(&dom, dout, bh, seq_q, DkvCfg<D>::BQ);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, bh, seq_k, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, bh, seq_k, ROWS);
  if (err == cudaSuccess) err = units_of<ROWS>(seq_k, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvCfg<D>::BYTES;
  return causal ? launch<bwd_dkv_kernel_sm90<D, true>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale)
                : launch<bwd_dkv_kernel_sm90<D, false>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale);
}

template <int D>
cudaError_t bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, int bh, int seq_q,
                        int seq_k, float scale, bool causal, cudaStream_t stream) {
  constexpr int ROWS = Items<D>::ROWS;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, bh, seq_q, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&dom, dout, bh, seq_q, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, bh, seq_k, DqCfg<D>::BN);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, bh, seq_k, DqCfg<D>::BN);
  if (err == cudaSuccess) err = units_of<ROWS>(seq_q, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = DqCfg<D>::BYTES;
  return causal ? launch<bwd_dq_kernel_sm90<D, true>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale)
                : launch<bwd_dq_kernel_sm90<D, false>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale);
}

}  // namespace

// ------------------------------------------------------------ C interface
// dtype: 0 = float32, 1 = bfloat16. head_dim: 64, 96, 128, 256 or 512 (the
// wrappers pad any other width up to 512 to the next of them). Each function
// returns the cudaError_t of its launch (0 on success); the kernel runs on
// `stream` and nothing here synchronises or allocates. f32 goes to F32_FN,
// the CUDA-core kernels; bf16 to BF16_FN, the tensor-core kernels.

#define RT_WIDTH(W, F32_FN, BF16_FN, ...) \
  if (head_dim == W) return dtype == 0 ? F32_FN<float, W>(__VA_ARGS__) : BF16_FN<W>(__VA_ARGS__);
#define RT_DISPATCH(F32_FN, BF16_FN, ...)                                 \
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue); \
  RT_WIDTH(64, F32_FN, BF16_FN, __VA_ARGS__)                              \
  RT_WIDTH(96, F32_FN, BF16_FN, __VA_ARGS__)                              \
  RT_WIDTH(128, F32_FN, BF16_FN, __VA_ARGS__)                             \
  RT_WIDTH(256, F32_FN, BF16_FN, __VA_ARGS__)                             \
  RT_WIDTH(512, F32_FN, BF16_FN, __VA_ARGS__)                             \
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
  RT_DISPATCH(bwd_dq, bwd_dq_sm90, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dq), bh, seq_q, seq_k, scale,
              causal != 0, static_cast<cudaStream_t>(stream))
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh, int seq_q,
                     int seq_k, int head_dim, float scale, int causal, int dtype, void* stream) {
  RT_DISPATCH(bwd_dkv, bwd_dkv_sm90, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
              bh, seq_q, seq_k, scale, causal != 0, static_cast<cudaStream_t>(stream))
}

const char* rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

#ifdef RT_TIMELINE
// Copies the stamps into dst (host memory, [3][2][64][6] int64) and clears them.
int rt_timeline(void* dst) {
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, timeline, sizeof(timeline));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, timeline);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(timeline));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
