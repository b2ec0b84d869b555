// Flash attention for Hopper (sm_90a): forward (with and without the
// log-sum-exp residual) and the two tiled backward kernels.
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   fwd_kernel<.., WRITE_LSE=false>  <- _attn_fwd_kernel      (B1)
//   fwd_kernel<.., WRITE_LSE=true>   <- _attn_fwd_kernel_lse  (B2)
//   bwd_dq_kernel                    <- _attn_bwd_dq_kernel   (B3)
//   bwd_dkv_kernel                   <- _attn_bwd_dkv_kernel  (B4)
//
// Layout [BH, T, D] for q/do/o and [BH, S, D] for k/v, row-major and
// contiguous; lse and delta are [BH, T] f32. Inputs are f32 or bf16, all
// arithmetic is f32. D is 64 or 128.
//
// What bounds them on the card. The least time for the work is set by the
// bytes at the train step's shape (causal, T = 1024, D = 64: ~256 flops per
// byte of q, k, v, o, just under the ~295 at which an H100's bf16 tensor
// cores stop waiting on memory), so a fast kernel reads each input once and
// keeps everything O(T*S) on chip. This first version does its arithmetic
// on the f32 CUDA cores (67 TFLOP/s, not the tensor cores' 989), and that is
// what bounds it in practice: a forward at that shape is 13 GFLOP, at least
// 0.19 ms on those cores. mma/wgmma and TMA are later work.
// What the design does about it:
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

// ---------------------------------------------------------------- launchers

// Every kernel takes more than the default 48 KB of shared memory, which a
// kernel is allowed only once its limit is raised on the device. Raise it at
// the kernel's first launch on each device, not at every launch: the smem
// size of one instantiation is fixed.
template <auto Kernel, typename... Args>
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
  Kernel<<<grid, NT, smem, stream>>>(args...);
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

}  // namespace

// ------------------------------------------------------------ C interface
// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Each function
// returns the cudaError_t of its launch (0 on success); the kernel runs on
// `stream` and nothing here synchronises or allocates.

#define RT_DISPATCH(FN, ...)                                                           \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);                 \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__);               \
  if (dtype == 1 && head_dim == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
  if (dtype == 1 && head_dim == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);       \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" {

int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                 int seq_q, int seq_k, int head_dim, float scale, int causal, int dtype,
                 void* stream) {
  RT_DISPATCH(fwd, q, k, v, o, static_cast<float*>(lse), bh, seq_q, seq_k, scale, causal != 0,
              static_cast<cudaStream_t>(stream))
}

int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int bh, int seq_q, int seq_k,
                    int head_dim, float scale, int causal, int dtype, void* stream) {
  RT_DISPATCH(bwd_dq, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dq), bh, seq_q, seq_k, scale,
              causal != 0, static_cast<cudaStream_t>(stream))
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh, int seq_q,
                     int seq_k, int head_dim, float scale, int causal, int dtype, void* stream) {
  RT_DISPATCH(bwd_dkv, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
              bh, seq_q, seq_k, scale, causal != 0, static_cast<cudaStream_t>(stream))
}

const char* rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
