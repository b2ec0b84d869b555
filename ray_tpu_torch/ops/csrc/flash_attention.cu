// Flash attention for Hopper (sm_90a): forward (with and without the
// log-sum-exp residual) and the two tiled backward kernels.
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   bf16 inputs (the train step's)          f32 inputs
//   fwd_kernel_sm90<.., WRITE_LSE=false>    fwd_kernel_sm90_f32<.., WRITE_LSE=false>  <- _attn_fwd_kernel      (B1)
//   fwd_kernel_sm90<.., WRITE_LSE=true>     fwd_kernel_sm90_f32<.., WRITE_LSE=true>   <- _attn_fwd_kernel_lse  (B2)
//   bwd_dq_kernel_sm90                      bwd_dq_kernel_sm90_f32                    <- _attn_bwd_dq_kernel   (B3)
//   bwd_dkv_kernel_sm90                     bwd_dkv_kernel_sm90_f32                   <- _attn_bwd_dkv_kernel  (B4)
// and, past D = 512 (bf16 and f32) and for f32 at 512, the same four with
// the contraction over D streamed in chunks: fwd_kernel_sm90_stream<P, ..,
// WRITE_LSE> (B1, B2; see "The forward past 512" below),
// bwd_dq_kernel_sm90_stream and bwd_dkv_kernel_sm90_stream (B3, B4; "The
// backward past 512"). The f32 kernels take their operands from
// split_kernel, which replaces no TPU kernel (see "The f32 forward" and "The
// f32 backward" below). Every kernel runs on the tensor cores.
//
// Layout [BH, T, D] for q/do/o and [BH, S, D] for k/v, row-major and
// contiguous; lse and delta are [BH, T] f32; dq, dk and dv are f32. D is 32,
// 64, 96, 128, 256 or 512, and for the streamed kernels any multiple of 512;
// the wrappers (flash_attention.py) run any other head dim, as the TPU
// kernels take any, at the next of these, zero-padded. Any number of heads
// BH, as the TPU kernels' grid takes: the Hopper kernels are persistent and
// every offset into a tensor is formed in size_t. All sums are f32.
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
//
// The f32 forward (fwd_kernel_sm90_f32, after the bf16 forward) runs f32
// attention on the bf16 tensor cores: every f32 call of flash_attention,
// mha, the autograd function, a transformer built in f32 and the ring's
// and Ulysses' kernel routes takes it at D = 32, 64, 96, 128 and 256.
//   1. The split. split_kernel writes each f32 operand x of q, k and v as
//      hi = bf16(x) and lo = bf16(x - hi) (to nearest; |x - hi - lo| <=
//      2^-16 |x|), and the kernel splits P the same way on chip (split_p).
//      Each product is then three bf16 products summed into f32: a.b =
//      a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, leaving out a_lo.b_lo and the
//      parts' own error (each at most 2^-16 of |a||b|). The emulation of this
//      kernel in tests/test_torch_f32_forward.py settled that set: at D =
//      64-256, T = 192 and 1000, causal or not, it stays within 1.96e-5 of
//      the f32 plain version (F32_ATOL is 2e-4; the card's worst in phase
//      2's cases is of that order), and with any one of the three products
//      of S or of P.V left out (P.V without P_lo.V_hi is P rounded once) it
//      misses F32_ATOL by 10x or more at every width. A
//      third part (x = hi + mid + lo, six products) would take S and o to
//      ~1e-6, which no check of the port asks for, at twice the tensor
//      work and 1.5x the bytes of the parts.
//   2. Why bf16 parts and not TF32: wgmma reads TF32 from shared memory only
//      K-major (the transpose bits exist for 16-bit types only), so P.V
//      would need each V tile transposed on chip, and TF32's accumulator
//      fragment is not its A fragment; with bf16 parts the bf16 forward's
//      machinery serves unchanged: Lay<D>'s TMA boxes and swizzles, the
//      descriptors, RS P.V with P straight from the S fragment, the
//      persistent units and the producer warpgroup.
//   3. What bounds it: the tensor work, six bf16 products a (q, key) pair
//      and column where the bf16 forward does three (S once, P.V twice),
//      and, beside it, the bytes of the parts: split_kernel moves 8 bytes
//      an element (4 in, 4 out) and the forward reads 4. The least time for
//      f32 attention within F32_ATOL on this card is three bf16 products at
//      989 TFLOP/s, ~330 TFLOP/s of useful work (chip_smoke.py PEAK_F32_SPLIT).
//   4. Tiles (F32FwdCfg): the parts take 4 bytes an element, so the kernel
//      at D has the bytes of the bf16 forward at 2D. Items of 128 q rows at
//      every width; K and V stream through rings of their own, so K_kt's
//      stage is refilled as soon as S_kt is in, while P_{kt-1}.V_{kt-1}
//      still holds V's. D = 256 streams 16-key tiles (Q's parts 128 KB).
//   5. The split is a pass of its own, once a call, so each part is read by
//      TMA as the bf16 kernel reads bf16: its bytes (two a byte of f32 q, k
//      and v, ~0.6 ms a GB of them at 3.35 TB/s) are the price of that;
//      splitting on chip would save them.
//
// The f32 backward (bwd_dq_kernel_sm90_f32, bwd_dkv_kernel_sm90_f32) is the
// bf16 backward's two kernels with every operand in parts (their bodies,
// bwd_dq_body and bwd_dkv_body, take P = 1 or 2 parts), so it keeps their
// persistent units, producer warpgroup, mbarrier rings, cp.async stat slots
// and no atomics: a train step's f32 gradients repeat bitwise.
//   1. Operands. q, k, v and do as split_kernel's hi and lo parts, each part
//      a head of a [2 BH, rows, D] map, loaded side by side into a stage; the
//      autograd function saves the forward's parts of q, k and v and splits
//      do alone, and the ring's hop splits its four once for both kernels.
//   2. Products. S and dP (S^T and dP^T in bwd_dkv) on SS wgmma, dQ, dK and
//      dV on RS wgmma with P and dS split on chip (the bf16 backward's
//      split: hi by truncation, lo to nearest), each as three bf16 products
//      (hi.hi + hi.lo + lo.hi). tests/test_torch_f32_backward.py emulated
//      both kernels tile by tile: at D = 64-256, T = 192 and 1000, T != S,
//      causal or not, within 0.5 of F32_ATOL of the f32 plain versions, and
//      any of the five products with one of its three left out misses
//      F32_ATOL by 18x or more.
//   3. Tiles (DqCfg<D, 2>, DkvCfg<D, 2>). Registers are bf16's at D, shared
//      memory bf16's at 2D: bwd_dq 64-key K/V tiles at 64 (4 stages), 32
//      at 96 (4) and 128 (3), and at 256 the 64-row items of bf16 at 512
//      (Items<256, true>: both consumer warpgroups make S and dP for the
//      item's rows, each holds 128 of dQ's columns) with 16-key tiles;
//      bwd_dkv 64-row Q/dO tiles at 64, 32 at 96 and 128, 16 at 256 (64-row
//      items, each warpgroup's 128 dK and dV columns in one pass). At 128
//      and 256 the producer, with twice the TMA loads a tile, takes 40
//      registers (DkvCfg::PRODUCER_REGS) and each consumer 232.
//   4. What bounds them: as the f32 forward, three bf16 products a product,
//      ~330 TFLOP/s of useful work; at 256 the m64n16 S and dP products,
//      which re-read their A operand from shared memory for 16 columns and
//      are made twice (once a warpgroup).

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
// The Hopper kernels at D = 32 (the JAX package's example's head dim; a
// head dim below it runs padded to it). A tile is one Lay<32> box, 64-byte
// rows in the 64-byte swizzle (one of D = 96's three); S = Q.K^T is two
// 16-column k steps, and P.V, dQ += dS.K, dV += P^T.dO and dK += dS^T.Q are
// m64n32k16 products with A from registers (wgmma_rs on d[16]).
//   * What bounds them: the exps, not the flops. A (q, key) pair takes one
//     exp2 in each of B1-B4 and 4 D = 128 useful flops in the forward (6 D
//     in B3, 8 D in B4): at 989 TFLOP/s the tensor cores would take ~7.7 T
//     pairs/s of the forward, the exp unit (16 ex2 a clock an SM, 132 SMs
//     at 1.98 GHz) ~4.2 T/s, so the least time is the exps' (chip_smoke.py's
//     bound counts them; only B4's flops come to as much). Halving D from
//     64 halves a tile's tensor work and leaves its softmax: the forward's
//     consumer tile takes ~2580 cycles against ~2970 at 64 (kernel_ab
//     --timeline, on an H100: issuing S and P.V ~480 against ~900, the
//     softmax ~1350, rescaling and splitting P ~360), and the tensor cores
//     stand idle most of it.
//   * So the tiles take as many keys as the registers hold, spreading each
//     tile's fixed costs (barriers, the row max's shuffles, the rescale)
//     over more exps: 128 keys in both forwards (S and P take 128
//     registers) and in bwd_dq (S, dP and the split dS 192 beside dQ's 16),
//     64 q rows in bwd_dkv (D = 64's: 128 rows of S^T, dP^T and their
//     splits would take 256). FwdCfg, F32FwdCfg, DqCfg and DkvCfg give the
//     times of the choices that lost.
//   * Not tried: moving part of the exps to the FMA pipe (a polynomial
//     exp2), the one way past the exp unit's rate.
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
// Past 512, Q, K and V tiles of 64 rows no longer leave room for a stream,
// nor do f32 parts at 512 (Q's two parts 128 KB): there every kernel streams
// its contraction over D (the two sections below).
//
// The forward past 512 (fwd_kernel_sm90_stream, StreamCfg), bf16 (P = 1)
// and f32 as split_kernel's parts (P = 2, at 512 too). D is a runtime
// multiple of 512: one instantiation for each (P, CAUSAL, WRITE_LSE), 8 in
// all, serves every width.
//   1. Items and slices. An item is 64 q rows of one head by one slice of
//      512 output columns; its two consumer warpgroups each hold 256 of
//      O's columns (128 registers), as the bf16 kernel at 512. A head of
//      width D takes D / 512 slices, units of their own, slice fastest, so
//      the blocks at work at one time read one row tile's Q and K from L2.
//   2. S's contraction, streamed. S = sum_c Q_c.K_c^T over chunks of 128
//      bf16 bytes a row in all parts (G = 128 columns at P = 1, 64 in two
//      parts at P = 2; three products a chunk at P = 2, the f32 forward's
//      set): the producer loads each (Q chunk, K chunk) pair into a ring
//      (StreamCfg: 64-key tiles in three 32 KB stages at P = 1, 32-key
//      tiles in four 24 KB ones at P = 2), so an item's Q is re-read from
//      L2 once for each K/V tile (a Q resident in shared memory would take
//      128 KB at f32 512 and bf16 1024, and more past them). A consumer
//      issues chunk c's products once its stage has landed and frees chunk
//      c - 1's once those are in (one commit group in flight behind the
//      issue; two, 9-23% slower in turns on an H100, held stages longer).
//      The cycle stamps (kernel_ab --timeline) put ~70% of a tile in that
//      issue step: the stream of Q and K chunks from L2 sets the pace.
//   3. P.V takes the slice's columns of a V tile (BN x 512 x P) from a ring
//      of two stages of its own; tile kt's S is issued before P_{kt-1}
//      .V_{kt-1}, whose products run under tile kt's softmax, as in the
//      bf16 forward.
//   4. lse. Every slice of a row tile makes S from the same chunks in the
//      same order with the same instructions, so all slices' m and l agree
//      bitwise; slice 0's warpgroup 0 writes lse.
//   5. The tensor work, against the useful 4 D flops a (q, key) pair: both
//      warpgroups make S and each slice makes it again, so S takes 2 D / 512
//      times its useful work and P.V once: (2 D / 512 + 1) / 2 the useful
//      work, 1.5x at 512, 2.5x at 1024, 4.5x at 2048 (times 3 at P = 2, the
//      bf16 products of each f32 one).
//
// The backward past 512 (bwd_dq_kernel_sm90_stream, DqStreamCfg;
// bwd_dkv_kernel_sm90_stream, DkvStreamCfg), bf16 (P = 1) and f32 as
// split_kernel's parts (P = 2, at 512 too), D a runtime multiple of 512:
// 4 instantiations each over (P, CAUSAL) serve every width. The forward's
// design, applied to both backward kernels:
//   1. Items and slices. bwd_dq: 64 q rows of one head by one slice of 512
//      dQ columns, each consumer warpgroup holding 256 (128 registers, as
//      the bf16 kernel at 512). bwd_dkv: 64 k rows by one slice of 256
//      columns of dK and dV, each warpgroup holding 128 of each (dK and dV
//      of 256 columns would take 256 registers a thread). A head takes D /
//      512 (D / 256) slices, units of their own, slice fastest, in the
//      forward's persistent units.
//   2. S = sum_c Q_c.K_c^T and dP = sum_c dO_c.V_c^T (S^T = sum_c
//      K_c.Q_c^T and dP^T = sum_c V_c.dO_c^T in bwd_dkv), streamed over
//      StreamCfg's chunks of 128 bf16 bytes a row in all parts: the
//      producer loads each tile's four chunks (Q, dO, K and V) into one
//      stage of a ring, so bwd_dq re-reads an item's Q and dO from L2 once
//      for each K/V tile, and bwd_dkv an item's K and V once for each Q/dO
//      tile. A consumer issues chunk c's products once its stage has landed
//      and frees chunk c - 1's once those are in, as the forward does.
//   3. The products into the outputs take the slice's columns of the
//      streamed operand from a ring of two stages of their own: K's 512
//      for dQ += dS.K; Q's and dO's 256 for dK += dS^T.Q and dV += P^T.dO.
//      Tile t's S and dP are issued before tile t-1's products, which run
//      under tile t's P and dS (the previous tile's split operands held
//      beside them: bwd_dq's 32-key tiles at P = 1 and 16-key ones at P =
//      2, bwd_dkv's 16-row Q/dO tiles leave the registers for it).
//   4. Every slice (and both warpgroups) makes S and dP from the same
//      chunks in the same order with the same instructions, so P and dS
//      agree bitwise across slices; no atomics, each output element written
//      once: a train step's gradients repeat bitwise. bwd_dq's consumers
//      load their rows' lse and delta once an item; bwd_dkv's producer warp
//      copies a Q/dO tile's by cp.async into slots counted on the tile's
//      slice stage (1 + 32 arrivals), as bwd_dkv_body does.
//   5. The product set at P = 2 is the f32 backward's: S, dP, dQ, dK and dV
//      each three bf16 products (hi.hi + hi.lo + lo.hi), P and dS split on
//      chip as bwd_dq_body and bwd_dkv_body split them. Streaming changes
//      only the order of S's and dP's sums; tests/test_torch_stream_backward.py
//      emulates both kernels chunk by chunk at 512 and 1024.
//   6. The tensor work, against the useful work of a (q, key) pair (6 D
//      flops in bwd_dq: S, dP, dQ; 8 D in bwd_dkv: S, dP, dK, dV). Both
//      warpgroups make S and dP and each slice makes them again; the
//      products into the outputs take two bf16 products each at P = 1 (the
//      split operand's hi and lo). bwd_dq: (8 D / 512 + 4) / 6 the useful
//      work at P = 1, 2x at 512, 3.3x at 1024, 6x at 2048; at P = 2 (three
//      bf16 products each) (24 D / 512 + 6) / 6, 5x at 512, 9x at 1024.
//      bwd_dkv: (8 D / 256 + 8) / 8 = D / 256 + 1, 3x at 512, 5x at 1024,
//      9x at 2048; at P = 2 (24 D / 256 + 12) / 8, 7.5x at 512, 13.5x at
//      1024. Two warpgroups sharing S and dP through shared memory, one
//      making S and the other dP, would halve the recompute's share; the
//      stream of chunks from L2 (bwd_dq at P = 2: an item's Q and dO, 256
//      KB, and 64 KB of K and V a 16-key tile) sets the pace first.
//   7. Shared memory (each config's static_assert): bwd_dq at P = 1, 48 KB
//      S stages x 3 + 32 KB K slices x 2 (208 KB); at P = 2, 40 KB x 4 +
//      32 KB x 2 (224 KB); bwd_dkv 40 KB x 4 + 16 KB (P = 1) or 32 KB (P =
//      2) slices x 2.

#include <cuda.h>  // CUtensorMap and its enums; no driver function is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr float BIG_NEG = -1e30f;  // masked score, as _BIG_NEG in the reference

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
// 32-column boxes, 64-byte rows and the 64-byte swizzle; D = 32 one such
// box. ATOM is the swizzle's period, 8 rows; a row holds KPB of wgmma's
// 16-column k steps.
template <int D>
struct Lay {
  static_assert(D % 64 == 0 || D == 96 || D == 32, "the Hopper kernels take D = 32, 64, 96, 128, 256 or 512");
  static constexpr int BW = D % 64 == 0 ? 64 : 32;
  static constexpr int RB = 2 * BW;
  static constexpr int ATOM = 8 * RB;
  static constexpr int KPB = BW / 16;
  static constexpr uint64_t DESC_SWIZZLE = BW == 64 ? 1 : 2;  // wgmma descriptor: 128B, 64B
};

// The rows of a work item and how its two consumer warpgroups share it: up
// to D = 256, 128 rows, 64 a warpgroup; at D = 512 (COLS), 64 rows, both
// warpgroups on all of them, warpgroup w holding output columns [OUT w,
// OUT w + OUT) (see the file's header). The f32 backward, whose operands
// come in two parts, takes COLS at D = 256: it has the bytes of bf16 at 2D.
template <int D, bool COLS_ = D == 512>
struct Items {
  static constexpr bool COLS = COLS_;
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
// tiles in two stages (192 KB in all). At D = 32 a 128-key K or V tile is 8
// KB: the registers (S and P of 128 keys take 128 of them) bound the tile,
// not shared memory: 0.2226 ms against 0.2447 for 64-key tiles and 0.2743
// for 128 in two stages at [128, 2048, 32] (64-key tiles 0.0103 against
// 0.0111 at the example's launch-bound [64, 256, 32]), in turns on an H100.
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
// As tma_load_3d, into the shared address dst.
__device__ __forceinline__ void tma_load_at(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int row,
                                            int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
      "r"(c0), "r"(row), "r"(head)
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
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
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
// products in, 5 split), 3 the f32 forward (the forward's events), 4 and
// 5 the f32 bwd_dq and bwd_dkv (the backward's events), 6 the streamed
// forward (0 the tile begins, 1 S issued chunk by chunk, 2 the previous
// tile's P.V issued, 3 S in, 4 softmax done, 5 P.V in, rescaled, P split),
// 7 and 8 the streamed bwd_dq and bwd_dkv (0 the tile begins, 1 S and dP
// issued chunk by chunk, 2 the previous tile's products issued, 3 S and dP
// in, 4 P and dS made, 5 the previous tile's products in, split). Only
// ray_tpu_torch/ops/kernel_ab.py's timeline build defines RT_TIMELINE
// (chip_smoke.py phase 2 reads it through rt_timeline); the library the
// port loads has no stamps.
constexpr int TIMELINE_TILES = 64;
__device__ long long timeline[9][2][TIMELINE_TILES][6];
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

// ============================================== forward on Hopper (f32, sm_90a)
//
// fwd_kernel_sm90_f32 replaces _attn_fwd_kernel (WRITE_LSE = false, B1) and
// _attn_fwd_kernel_lse (WRITE_LSE = true, B2) for f32 inputs at D = 32, 64,
// 96, 128 and 256, on the tensor cores. See the file's header for the split, the
// product set and what bounds the kernel; split_kernel below makes its
// operands.

// split_kernel replaces no TPU kernel (the TPU's matrix unit takes f32
// operands): it is the f32 route's first pass, once a forward (q, k and v)
// and once a backward (do, the forward's parts of q, k and v saved; or all
// four). It reads each element of up to four f32 operands once and writes
// hi = bf16(x) and lo = bf16(x - hi) (both to nearest; x - hi is exact in
// f32), each part a [BH, rows, D] bf16 tensor, [x0 hi | x0 lo | x1 hi | x1
// lo | ...] in `parts`, so the kernels read them by TMA as they read bf16
// operands. Bound by bytes (4 in and 4 out an element): one 16-byte load
// and two 8-byte stores a thread a step, every access coalesced. n0-n3
// count each operand's float4s (D is a multiple of 4); blockIdx.y picks the
// operand. The operands are __restrict__ parameters, not an array of
// pointers: read through one (a struct's, indexed by blockIdx.y) the loads
// were not known apart from the stores, and the pass took 1.75x as long.
__global__ void __launch_bounds__(256) split_kernel(const float4* __restrict__ x0, const float4* __restrict__ x1,
                                                    const float4* __restrict__ x2, const float4* __restrict__ x3,
                                                    uint2* __restrict__ parts, size_t n0, size_t n1, size_t n2,
                                                    size_t n3) {
  const unsigned y = blockIdx.y;
  const float4* x = y == 0 ? x0 : y == 1 ? x1 : y == 2 ? x2 : x3;
  const size_t n = y == 0 ? n0 : y == 1 ? n1 : y == 2 ? n2 : n3;
  uint2* hi = parts + 2 * ((y > 0 ? n0 : 0) + (y > 1 ? n1 : 0) + (y > 2 ? n2 : 0));  // uint2s: 4 bf16
  uint2* lo = hi + n;
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n; i += size_t(gridDim.x) * 256) {
    const float4 e = x[i];
    uint2 h, l;
    split_bf16x2(e.x, e.y, h.x, l.x);
    split_bf16x2(e.z, e.w, h.y, l.y);
    hi[i] = h;
    lo[i] = l;
  }
}

// Tiles and shared memory of fwd_kernel_sm90_f32, in bytes. Each operand
// comes in two bf16 parts, 4 bytes an element, so the kernel at D has the
// bytes of the bf16 one at 2D. Items of 128 q rows (64 a consumer) at
// every width; K and V in rings of their own (a K stage is free once S is
// in, a V stage once P.V is), STAGES each:
//   D = 32: 128-key tiles, 3 stages (Q 16 KB, the rings 96 KB), as the
//     bf16 forward at 32 (registers, not bytes, bound the tile): with its
//     split pass 0.3201 ms against 0.3543 for 64-key tiles and 0.3181 in
//     four stages at [128, 2048, 32];
//   D = 64: 128-key tiles, 3 stages (Q 32 KB, the rings 192 KB);
//   D = 96: 64 keys, 3 stages (48 KB, 144 KB);
//   D = 128: 64 keys, 2 stages (64 KB, 128 KB);
//   D = 256: 16 keys, 3 stages (128 KB, 96 KB): Q's parts for 128 rows take
//     half of the block's shared memory and the output sums 128 of a
//     consumer's 240 registers.
template <int D>
struct F32FwdCfg {
  static constexpr int BN = D <= 64 ? 128 : D == 256 ? 16 : 64;  // keys per K/V tile
  static constexpr int STAGES = D == 128 ? 2 : 3;                 // K stages, and V stages
  static constexpr int Q_PART = FWD_BQ * D * 2;                    // one part of an item's Q
  static constexpr int KV_PART = BN * D * 2;                       // one part of a K or V tile
  // Byte offsets from the aligned base: Q's parts, the K ring and the V ring
  // ([STAGES][2 parts] tiles each), then the barriers: q_full, q_empty, and
  // [STAGES] each of k_full, k_empty, v_full, v_empty.
  static constexpr int K_AT = 2 * Q_PART, V_AT = K_AT + 2 * STAGES * KV_PART;
  static constexpr int BAR_AT = V_AT + 2 * STAGES * KV_PART;
  static constexpr int BYTES = BAR_AT + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  // The producer's registers (setmaxnreg; each consumer gets 240 less half
  // the producer's excess over 24, so the three warpgroups keep 3 x 168). At
  // D = 256 the producer's eight TMA loads a tile (four boxes, two parts)
  // spilled in 24 registers; 40 there leave the consumers 232, no spill.
  static constexpr int PRODUCER_REGS = D == 256 ? 40 : 24;
};

// load_rows into the shared address dst: the f32 forward keeps every shared
// address as one base plus constants, so its producer (24 registers) holds
// no pointers.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows_at(uint32_t dst, const CUtensorMap* map, uint32_t bar, int head,
                                             int row) {
  constexpr int BW = Lay<D>::BW;
#pragma unroll
  for (int c = 0; c < D / BW; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + c * ROWS * BW * 2),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c * BW), "r"(row), "r"(head)
        : "memory");
}

// s += Q.K^T of one tile, as issue_s, every product added to s.
template <int D, int AROWS, int N>
__device__ __forceinline__ void issue_s_add(float (&s)[N], uint32_t q_addr, uint32_t k_addr) {
  using L = Lay<D>;
  asm volatile("" : "+r"(q_addr), "+r"(k_addr));
  const uint64_t a0 = smem_desc<D>(q_addr, 16, L::ATOM), b0 = smem_desc<D>(k_addr, 16, L::ATOM);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int box = kc / L::KPB, at = kc % L::KPB * 32;
    wgmma_ss<1>(s, a0 + ((box * AROWS * L::RB + at) >> 4), b0 + ((box * 2 * N * L::RB + at) >> 4));
  }
}

// S = Q_hi.K_hi^T + Q_hi.K_lo^T + Q_lo.K_hi^T of one tile (the lo part of
// each operand lies q_lo and k_lo bytes past its hi part): the product set
// within phase 2's f32 limit (Q_lo.K_lo^T, at most 2^-16 of |Q||K|, is left out).
template <int D, int AROWS, int N>
__device__ __forceinline__ void issue_s_split(float (&s)[N], uint32_t q_addr, uint32_t k_addr, uint32_t q_lo,
                                              uint32_t k_lo) {
  issue_s<D, AROWS, true>(s, q_addr, k_addr);
  issue_s_add<D, AROWS>(s, q_addr, k_addr + k_lo);
  issue_s_add<D, AROWS>(s, q_addr + q_lo, k_addr);
}

// acc += P.V of one tile for one part P of P and one part of V, as issue_pv.
template <int D, int NC>
__device__ __forceinline__ void issue_pv_part(float (&acc)[D / 2], const uint32_t (&p)[NC][4], uint32_t v_addr) {
  using L = Lay<D>;
  constexpr int BOX = 16 * NC * L::RB;
  asm volatile("" : "+r"(v_addr));
  const uint64_t b0 = smem_desc<D>(v_addr, BOX, L::ATOM);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint64_t b = b0 + ((c * 16 * L::RB) >> 4);
    if constexpr (D == 256) {
      wgmma_rs_at<0>(acc, p[c], b);
      wgmma_rs_at<64>(acc, p[c], b + ((2 * BOX) >> 4));
    } else {
      wgmma_rs(acc, p[c], b);
    }
  }
}

// acc += P_hi.V_hi + P_lo.V_hi + P_hi.V_lo (V's lo part v_lo bytes past its
// hi part; P_lo.V_lo left out, as in S).
template <int D, int NC>
__device__ __forceinline__ void issue_pv_split(float (&acc)[D / 2], const uint32_t (&p_hi)[NC][4],
                                               const uint32_t (&p_lo)[NC][4], uint32_t v_addr, uint32_t v_lo) {
  issue_pv_part<D>(acc, p_hi, v_addr);
  issue_pv_part<D>(acc, p_lo, v_addr);
  issue_pv_part<D>(acc, p_hi, v_addr + v_lo);
}

// fwd_kernel_sm90's persistent units, producer and consumer pipeline, with
// each operand in two parts: the maps are 3-D over [2 BH, rows, D], head h's
// hi part at head h and its lo part at head h + bh. The producer loads an
// item's Q (both parts) once, and each K/V tile's K into the K ring and its
// V into the V ring. A consumer issues S_kt = Q.K_kt^T (three products)
// with P_{kt-1}.V_{kt-1} (three), frees K_kt's stage once S_kt is in, runs
// tile kt's softmax while P_{kt-1}.V_{kt-1} is on the tensor cores, and
// frees V_{kt-1}'s stage once that is in. o is f32.
template <int D, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1) fwd_kernel_sm90_f32(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, float* __restrict__ o, float* __restrict__ lse, int bh,
    int seq_q, int seq_k, float scale) {
  using Cfg = F32FwdCfg<D>;
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES, ROWS = FWD_BQ;
  constexpr int QP = Cfg::Q_PART, KP = Cfg::KV_PART;  // bytes of one part of Q, of a K or V tile
  extern __shared__ unsigned char fwd_f32_smem[];
  // Q: [2 parts][D / BW][ROWS][BW] at sm; each K and V stage [2 parts][D / BW][BN][BW].
  const uint32_t sm = smem_u32(swizzle_base(fwd_f32_smem));
  const uint32_t q_full = sm + Cfg::BAR_AT;        // the item's Q landed
  const uint32_t q_empty = q_full + 8;             // both consumers are done with Q
  const uint32_t k_full = q_empty + 8;             // [STAGES]: the stage's K landed
  const uint32_t k_empty = k_full + 8 * STAGES;    // [STAGES]: both consumers' S are in
  const uint32_t v_full = k_empty + 8 * STAGES;    // [STAGES]: the stage's V landed
  const uint32_t v_empty = v_full + 8 * STAGES;    // [STAGES]: both consumers' P.V are in
  auto k_at = [&](int st) { return sm + Cfg::K_AT + st * 2 * KP; };
  auto v_at = [&](int st) { return sm + Cfg::V_AT + st * 2 * KP; };

  const int n_qt = (seq_q + ROWS - 1) / ROWS, n_units = (n_qt + 1) / 2 * bh;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one thread keeps Q and both rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0, n = 0, head, q0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          mbar_wait(q_empty, (n & 1) ^ 1);
          mbar_expect_tx(q_full, 2 * Cfg::Q_PART);
          for (int part = 0; part < 2; ++part)  // hi, then lo
            load_rows_at<ROWS, D>(sm + part * QP, &q_map, q_full, head + part * bh, q0);
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++it) {
            const int st = it % STAGES, parity = (it / STAGES & 1) ^ 1;
            mbar_wait(k_empty + 8 * st, parity);
            mbar_expect_tx(k_full + 8 * st, 2 * KP);
            for (int part = 0; part < 2; ++part)
              load_rows_at<BN, D>(k_at(st) + part * KP, &k_map, k_full + 8 * st, head + part * bh, kt * BN);
            mbar_wait(v_empty + 8 * st, parity);
            mbar_expect_tx(v_full + 8 * st, 2 * KP);
            for (int part = 0; part < 2; ++part)
              load_rows_at<BN, D>(v_at(st) + part * KP, &v_map, v_full + 8 * st, head + part * bh, kt * BN);
          }
        }
    }
  } else {  // consumer warpgroup wg: q rows [q0 + 64 wg, + 64) of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = sm + wg * 64 * Lay<D>::RB;
    float s[BN / 2], acc[D / 2], alpha[2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];

    int it = 0, n = 0, head, q0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
        const int row0 = q0 + wg * 64;
        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};

        mbar_wait(q_full, n & 1);
        bar_arrive_if(1, wg == 1);  // warpgroup 0 issues first
        const int st0 = it % STAGES;
        mbar_wait(k_full + 8 * st0, it / STAGES & 1);
        bar_sync(1 + wg);
        keep(s);
        wgmma_fence();
        issue_s_split<D, ROWS>(s, q_addr, k_at(st0), QP, KP);
        wgmma_commit();
        keep(s);
        bar_arrive_if(2 - wg, wg == 0 || n_kv_tiles > 1);
        wgmma_wait<0>();
        keep(s);
        mbar_arrive_if(k_empty + 8 * st0, tid == 0);
        mbar_arrive_if(q_empty, tid == 0 && n_kv_tiles == 1);
        softmax_tile<CAUSAL>(s, m, l, alpha, 0, row0, r0, tg, seq_k, sl2);
        split_p(s, p_hi, p_lo);
        for (int kt = 1; kt < n_kv_tiles; ++kt) {
          const int st = (it + kt) % STAGES, prev = (it + kt - 1) % STAGES;
          mbar_wait(k_full + 8 * st, (it + kt) / STAGES & 1);
          mbar_wait(v_full + 8 * prev, (it + kt - 1) / STAGES & 1);
          STAMP(3, it + kt, 0);
          bar_sync(1 + wg);
          keep(s);
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          wgmma_fence();
          issue_s_split<D, ROWS>(s, q_addr, k_at(st), QP, KP);
          wgmma_commit();
          issue_pv_split<D>(acc, p_hi, p_lo, v_at(prev), KP);
          wgmma_commit();
          STAMP(3, it + kt, 1);
          keep(s);
          keep(acc);
          bar_arrive_if(2 - wg, wg == 0 || kt + 1 < n_kv_tiles);
          wgmma_wait<1>();  // S_kt is in: K_kt's stage is free
          keep(s);
          STAMP(3, it + kt, 2);
          mbar_arrive_if(k_empty + 8 * st, tid == 0);
          mbar_arrive_if(q_empty, tid == 0 && kt + 1 == n_kv_tiles);
          softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN, row0, r0, tg, seq_k, sl2);
          STAMP(3, it + kt, 3);
          wgmma_wait<0>();  // P_{kt-1}.V_{kt-1} is in: its P and V's stage are free
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          STAMP(3, it + kt, 4);
          mbar_arrive_if(v_empty + 8 * prev, tid == 0);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[i % 4 / 2];
          split_p(s, p_hi, p_lo);
          STAMP(3, it + kt, 5);
        }
        it += n_kv_tiles;
        const int last = (it - 1) % STAGES;
        mbar_wait(v_full + 8 * last, (it - 1) / STAGES & 1);
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        wgmma_fence();
        issue_pv_split<D>(acc, p_hi, p_lo, v_at(last), KP);
        wgmma_commit();
        keep(acc);
        wgmma_wait<0>();
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        mbar_arrive_if(v_empty + 8 * last, tid == 0);

#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r;
          const float lsafe = fmaxf(quad_sum(l[r]), 1e-30f), linv = 1.f / lsafe;
          if (qp >= seq_q) continue;
          float* orow = o + (static_cast<size_t>(head) * seq_q + qp) * D;
#pragma unroll
          for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<float2*>(orow + c * 8 + 2 * tg) =
                make_float2(acc[4 * c + 2 * r] * linv, acc[4 * c + 2 * r + 1] * linv);
          if (WRITE_LSE && tg == 0) lse[static_cast<size_t>(head) * seq_q + qp] = m[r] * LN2 + logf(lsafe);
        }
      }
  }
}

// ===================================== forward on Hopper, S's contraction streamed
//
// fwd_kernel_sm90_stream replaces _attn_fwd_kernel (WRITE_LSE = false, B1)
// and _attn_fwd_kernel_lse (WRITE_LSE = true, B2) where an item's Q no
// longer fits beside a stream of K and V tiles: bf16 (P = 1) past D = 512,
// f32 as split_kernel's parts (P = 2) at 512 and past. D is a runtime
// multiple of STREAM_SLICE; see the file's header for the design.

constexpr int STREAM_SLICE = 512;  // output columns of an item: 256 a consumer warpgroup

// Tiles and shared memory of fwd_kernel_sm90_stream, in bytes. An item is
// 64 q rows by one slice of STREAM_SLICE output columns. S = sum_c Q_c.K_c^T
// streams over chunks of G columns (128 bf16 bytes a row in all P parts, one
// or two 64-column boxes a part): each S stage holds an item's Q chunk and
// a K tile's chunk, through S_STAGES stages; P.V takes the slice's columns
// of a V tile (BN keys x 512 columns x P parts) from a ring of its own,
// V_STAGES deep. P = 2: 32-key tiles, 4 x 24 + 2 x 64 = 224 KB; P = 1:
// 64-key tiles, 3 x 32 + 2 x 64 = 224 KB (Q's re-reads from L2 halved per
// key: 0.3570 ms against 0.4639 for 32-key tiles in four stages at [8,
// 2048, 1024], 0.5846 against 0.8006-0.851 at [4, 2048, 2048], in turns on
// an H100; the f32 kernel's V tiles of 64 keys would take 128 KB a stage).
template <int P>
struct StreamCfg {
  static constexpr int ROWS = 64, BN = P == 1 ? 64 : 32, G = 128 / P;
  static constexpr int S_STAGES = P == 1 ? 3 : 4, V_STAGES = 2;
  static constexpr int Q_PART = ROWS * G * 2, K_PART = BN * G * 2;   // one part of a Q, K chunk
  static constexpr int S_BYTES = P * (Q_PART + K_PART);               // one S stage
  static constexpr int V_PART = BN * STREAM_SLICE * 2, V_BYTES = P * V_PART;  // one V stage
  static constexpr int V_AT = S_STAGES * S_BYTES, BAR_AT = V_AT + V_STAGES * V_BYTES;
  static constexpr int BYTES = BAR_AT + 8 * 2 * (S_STAGES + V_STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  // The producer's registers: at P = 2 its loop over the parts keeps its
  // counters and coordinates in 40 (as F32FwdCfg at 256), the consumers
  // 232; at P = 1 the consumers' 64-key S, P and output sums need 240 (one
  // instantiation spilled 4 bytes at 232), the producer 24.
  static constexpr int PRODUCER_REGS = P == 1 ? 24 : 40;
};

// S (FIRST: S =) += Q_c.K_c^T of one chunk of G columns, Q's 64 rows and
// K's 2N at q_addr and k_addr, each in P parts (P = 2: the lo part Q_PART
// and K_PART bytes past the hi part, K_PART a part of 2N rows; hi.hi +
// hi.lo + lo.hi, the f32 forward's product set). The streamed backward
// makes dP, S^T and dP^T with it too (dO, K or V in Q's place).
template <int P, bool FIRST, int N>
__device__ __forceinline__ void issue_s_chunk(float (&s)[N], uint32_t q_addr, uint32_t k_addr) {
  using Cfg = StreamCfg<P>;
  constexpr int G = Cfg::G, K_PART = 2 * N * G * 2;
  if constexpr (FIRST && P == 1) {
    issue_s<G, Cfg::ROWS, true>(s, q_addr, k_addr);
  } else if constexpr (FIRST) {
    issue_s_split<G, Cfg::ROWS>(s, q_addr, k_addr, Cfg::Q_PART, K_PART);
  } else {
    issue_s_add<G, Cfg::ROWS>(s, q_addr, k_addr);
    if constexpr (P == 2) {
      issue_s_add<G, Cfg::ROWS>(s, q_addr, k_addr + K_PART);
      issue_s_add<G, Cfg::ROWS>(s, q_addr + Cfg::Q_PART, k_addr);
    }
  }
}

// Work comes in fwd_kernel_sm90's units of two 64-row q tiles of one head,
// once for each slice of the head's output columns, slice fastest: the
// blocks at work at one time take the same rows' S from the same Q and K
// chunks, which L2 then serves. The producer's one thread loads, for each
// K/V tile of an item, its n_ch (Q chunk, K chunk) pairs into the S ring,
// then the slice's columns of V into the V ring. Both consumer warpgroups
// make S over all n_ch chunks for the item's 64 rows, chunk c's products
// issued once its stage has landed and its stage freed once they are in;
// then, as fwd_kernel_sm90, P_{kt-1}.V_{kt-1} for its 256 of the slice's
// columns, tile kt's softmax while that runs on the tensor cores, and the
// rescale. Every slice of a row tile makes S in the same chunk order, so
// their m and l agree bitwise; slice 0's warpgroup 0 writes lse. o is bf16
// (P = 1) or f32 (P = 2), [bh, seq_q, D].
template <int P, bool CAUSAL, bool WRITE_LSE>
__global__ void __launch_bounds__(FWD_THREADS, 1) fwd_kernel_sm90_stream(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, void* __restrict__ o, float* __restrict__ lse, int bh,
    int seq_q, int seq_k, int D, float scale) {
  using Cfg = StreamCfg<P>;
  constexpr int ROWS = Cfg::ROWS, BN = Cfg::BN, G = Cfg::G, SS = Cfg::S_STAGES, VS = Cfg::V_STAGES;
  constexpr int OUT = STREAM_SLICE / 2;  // a warpgroup's output columns
  extern __shared__ unsigned char fwd_stream_smem[];
  // S stage i: [P][G / 64][ROWS][64] of Q, then [P][G / 64][BN][64] of K;
  // V stage i: [P][STREAM_SLICE / 64][BN][64].
  const uint32_t sm = smem_u32(swizzle_base(fwd_stream_smem));
  const uint32_t s_full = sm + Cfg::BAR_AT;      // [SS]: the stage's Q and K chunks landed
  const uint32_t s_empty = s_full + 8 * SS;      // [SS]: both consumers' products of it are in
  const uint32_t v_full = s_empty + 8 * SS;      // [VS]: the stage's V landed
  const uint32_t v_empty = v_full + 8 * VS;      // [VS]: both consumers' P.V are in
  auto s_at = [&](int i) { return sm + i % SS * Cfg::S_BYTES; };
  auto v_at = [&](int i) { return sm + Cfg::V_AT + i % VS * Cfg::V_BYTES; };

  const int n_ch = D / G, n_slices = D / STREAM_SLICE;
  const int n_qt = (seq_q + ROWS - 1) / ROWS, n_units = (n_qt + 1) / 2 * bh * n_slices;
  if (threadIdx.x == 0) {
    for (int st = 0; st < SS; ++st) {
      mbar_init(s_full + 8 * st, 1);
      mbar_init(s_empty + 8 * st, 2);
    }
    for (int st = 0; st < VS; ++st) {
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one thread keeps both rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int is = 0, iv = 0, head, q0;  // S stages and V tiles loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int slice = u % n_slices;
        for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_qt, head, q0); ++j) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++iv) {
            for (int c = 0; c < n_ch; ++c, ++is) {
              const uint32_t full = s_full + 8 * (is % SS);
              mbar_wait(s_empty + 8 * (is % SS), (is / SS & 1) ^ 1);  // passes at once on the first lap
              mbar_expect_tx(full, Cfg::S_BYTES);  // out-of-range rows are zero-filled and counted
              for (int part = 0; part < P; ++part)
                for (int b = 0; b < G / 64; ++b) {
                  tma_load_at(s_at(is) + (part * G / 64 + b) * ROWS * 128, &q_map, full, c * G + 64 * b, q0,
                              head + part * bh);
                  tma_load_at(s_at(is) + P * Cfg::Q_PART + (part * G / 64 + b) * BN * 128, &k_map, full,
                              c * G + 64 * b, kt * BN, head + part * bh);
                }
            }
            const uint32_t full = v_full + 8 * (iv % VS);
            mbar_wait(v_empty + 8 * (iv % VS), (iv / VS & 1) ^ 1);
            mbar_expect_tx(full, Cfg::V_BYTES);
            for (int part = 0; part < P; ++part)
              for (int b = 0; b < STREAM_SLICE / 64; ++b)
                tma_load_at(v_at(iv) + (part * STREAM_SLICE / 64 + b) * BN * 128, &v_map, full,
                            slice * STREAM_SLICE + 64 * b, kt * BN, head + part * bh);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: the item's 64 rows, the slice's columns [OUT wg, OUT wg + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t v_col = wg * (OUT / 64) * BN * 128;  // this warpgroup's boxes of a V part
    float s[BN / 2], acc[OUT / 2], alpha[2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];

    // S of one tile over its n_ch chunks (stage `is` on): every chunk's
    // products but the last are in on return, their stages freed; the
    // last chunk's are one commit group in flight, its stage still held.
    auto issue_s_tile = [&](int is) {
      mbar_wait(s_full + 8 * (is % SS), is / SS & 1);
      issue_s_chunk<P, true>(s, s_at(is), s_at(is) + P * Cfg::Q_PART);
      wgmma_commit();
      keep(s);
      for (int c = 1; c < n_ch; ++c) {
        const int i = is + c;
        mbar_wait(s_full + 8 * (i % SS), i / SS & 1);
        issue_s_chunk<P, false>(s, s_at(i), s_at(i) + P * Cfg::Q_PART);
        wgmma_commit();
        keep(s);
        wgmma_wait<1>();  // chunk c - 1's products are in: its stage is free
        keep(s);
        mbar_arrive_if(s_empty + 8 * ((i - 1) % SS), tid == 0);
      }
    };
    auto issue_pv_tile = [&](int iv) {
      mbar_wait(v_full + 8 * (iv % VS), iv / VS & 1);
      if constexpr (P == 1)
        issue_pv<OUT>(acc, p_hi, p_lo, v_at(iv) + v_col);
      else
        issue_pv_split<OUT>(acc, p_hi, p_lo, v_at(iv) + v_col, Cfg::V_PART);
      wgmma_commit();
    };

    int is = 0, iv = 0, head, q0;  // S stages and V tiles consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int slice = u % n_slices;
      for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_qt, head, q0); ++j) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
        const int r0 = q0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) acc[i] = 0.f;
        float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};

        // Tile 0: S_0 alone.
        keep(s);
        wgmma_fence();
        issue_s_tile(is);
        is += n_ch;
        wgmma_wait<0>();
        keep(s);
        mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
        softmax_tile<CAUSAL>(s, m, l, alpha, 0, q0, r0, tg, seq_k, sl2);
        split_p(s, p_hi, p_lo);
        // Tile kt: S_kt chunk by chunk, then P_{kt-1}.V_{kt-1}; tile kt's
        // softmax while P_{kt-1}.V_{kt-1} is on the tensor cores.
        for (int kt = 1; kt < n_kv_tiles; ++kt, ++iv) {
          STAMP(6, iv, 0);
          keep(s);
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          wgmma_fence();
          issue_s_tile(is);
          is += n_ch;
          STAMP(6, iv, 1);
          issue_pv_tile(iv);
          STAMP(6, iv, 2);
          keep(s);
          keep(acc);
          wgmma_wait<1>();  // S_kt is in: its last chunk's stage is free
          keep(s);
          STAMP(6, iv, 3);
          mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
          softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN, q0, r0, tg, seq_k, sl2);
          STAMP(6, iv, 4);
          wgmma_wait<0>();  // P_{kt-1}.V_{kt-1} is in: its P and its V stage are free
          keep(acc);
          keep(p_hi);
          keep(p_lo);
          mbar_arrive_if(v_empty + 8 * (iv % VS), tid == 0);
#pragma unroll
          for (int i = 0; i < OUT / 2; ++i) acc[i] *= alpha[i % 4 / 2];
          split_p(s, p_hi, p_lo);
          STAMP(6, iv, 5);
        }
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        wgmma_fence();
        issue_pv_tile(iv);
        keep(acc);
        wgmma_wait<0>();
        keep(acc);
        keep(p_hi);
        keep(p_lo);
        mbar_arrive_if(v_empty + 8 * (iv % VS), tid == 0);
        ++iv;

        const int col = slice * STREAM_SLICE + wg * OUT;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r;
          const float lsafe = fmaxf(quad_sum(l[r]), 1e-30f), linv = 1.f / lsafe;
          if (qp >= seq_q) continue;
          const size_t at = (static_cast<size_t>(head) * seq_q + qp) * D + col;
#pragma unroll
          for (int c = 0; c < OUT / 8; ++c) {
            const float x = acc[4 * c + 2 * r] * linv, y = acc[4 * c + 2 * r + 1] * linv;
            if constexpr (P == 1)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o) + at + c * 8 + 2 * tg) =
                  __floats2bfloat162_rn(x, y);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(o) + at + c * 8 + 2 * tg) = make_float2(x, y);
          }
          // Every slice holds the row's m and l: slice 0's warpgroup 0 writes lse.
          if (WRITE_LSE && tg == 0 && slice == 0 && wg == 0)
            lse[static_cast<size_t>(head) * seq_q + qp] = m[r] * LN2 + logf(lsafe);
        }
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

// The tiles of both backward kernels for operands in P parts: P = 1, bf16;
// P = 2, the f32 backward's bf16 hi and lo parts (split_kernel), each part
// a head of a [2 BH, rows, D] tensor. Two parts take 4 bytes an element, so
// the f32 kernels at D have the shared-memory bytes of the bf16 ones at 2D
// (Items<D, D * P == 512>: 64-row items at f32 D = 256) and the registers
// of the bf16 ones at D.

// bwd_dkv: 128 k rows an item (64 per consumer warpgroup; at D * P = 512,
// 64 rows for both, Items), K and V loaded once an item; Q, dO, lse and
// delta stream in tiles of BQ q rows.
template <int D, int P = 1>
struct DkvCfg {
  using It = Items<D, D * P == 512>;
  // q rows per tile (the N of S^T = K.Q^T). At D = 128, dK and dV take 128
  // of a consumer thread's 240 registers, and a 64-row tile's S^T, dP^T and
  // their split operands (64 more) left ptxas spilling; D = 96 takes 128's
  // 32-row tiles. At D * P = 512, 16-row tiles: K and V of the item take
  // 128 KB. D = 32 takes 64's 64-row tiles (dK and dV 32 registers): 0.2923
  // ms against 0.3484 for 32-row tiles and 0.3662 in two stages (bf16),
  // 0.3875 against 0.4704 and 0.5004 (f32) at [128, 2048, 32] on an H100.
  static constexpr int BQ = D <= 64 ? 64 : D * P == 512 ? 16 : 32;
  // At bf16 D = 256, dK and dV would take 256 registers a thread: the
  // consumers make them in two passes over the item's q tiles, 128 columns
  // each (DA), and recompute S^T and dP^T in the second (K, V 128 KB for
  // the item, Q and dO tiles 32 KB a stage). At 512 each warpgroup's 256
  // columns (Items::OUT) take the same two passes; at f32 256 each
  // warpgroup's 128 take one.
  static constexpr int PASSES = P == 1 && D >= 256 ? 2 : 1;
  static constexpr int DA = It::OUT / PASSES;
  static constexpr int STAGES = D * P >= 256 ? 3 : 4;
  // Tile t's S^T and dP^T beside tile t-1's split operands, which dK and dV
  // at D = 128 and up leave no room for (at 96 0.5116 ms against 0.6261 in
  // turn at [128, 2048, 96] on an H100).
  static constexpr bool PIPE = D <= 96;
  static constexpr int KV_PART = It::ROWS * D * 2;  // one part of an item's K or V
  static constexpr int QT_PART = BQ * D * 2;        // one part of a Q or dO tile
  static constexpr int KV_BYTES = P * KV_PART;      // an item's K or V
  static constexpr int QT_BYTES = P * QT_PART;      // one Q or dO tile
  static constexpr int STAT_BYTES = 2 * BQ * 4;     // one tile's lse and delta
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 2 * KV_BYTES + STAGES * (2 * QT_BYTES + STAT_BYTES) + BAR_BYTES + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  // The producer warpgroup's registers (setmaxnreg; the consumers get 240
  // less half its excess over 24). The f32 kernels' producer issues twice
  // the TMA loads a tile, and at D >= 128 (the f32 forward spilled its
  // producer at 24 with eight loads a tile) takes 40.
  static constexpr int PRODUCER_REGS = P == 2 && D >= 128 ? 40 : 24;
};

// bwd_dq: 128 q rows an item (64 at D * P = 512, Items), Q and dO loaded
// once an item; K and V stream in tiles of BN keys, as in the forward.
template <int D, int P = 1>
struct DqCfg {
  using It = Items<D, D * P == 512>;
  // Keys per K/V tile: S and dP of tile kt beside tile kt-1's split dS, in
  // the consumers' registers. At D * P = 256 an item's Q and dO take 128
  // KB: 32-key tiles, three stages (224 KB in all); at 512 they take 128 KB
  // for 64 rows: 16-key tiles, three stages (224 KB). At f32 96 they take
  // 96 KB: 32-key tiles in four stages (192 KB; 0.7908 ms against 0.8883
  // for 64-key tiles in two stages, which left a tile ~3000 of its ~5700
  // cycles waiting for its load, at [128, 2048, 96] on an H100). At D = 32
  // S, dP and the split dS of 128 keys fit beside dQ's 16 registers:
  // 0.1916 ms against 0.2024 for 64-key tiles and 0.2550 for 32 (bf16),
  // 0.2562 against 0.2786 and 0.3380 (f32) at [128, 2048, 32], in turns on
  // an H100.
  static constexpr int BN = D == 32 ? 128 : D * P == 512 ? 16 : D * P == 256 || D * P == 192 ? 32 : 64;
  static constexpr int STAGES = D * P >= 256 ? 3 : 4;
  static constexpr int Q_PART = It::ROWS * D * 2;  // one part of an item's Q or dO
  static constexpr int KV_PART = BN * D * 2;       // one part of a K or V tile
  static constexpr int Q_BYTES = P * Q_PART;       // an item's Q or dO
  static constexpr int KV_BYTES = P * KV_PART;     // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  static constexpr int PRODUCER_REGS = P == 2 && D >= 128 ? 40 : 24;  // as DkvCfg's
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
// in registers until the item ends. With P = 2 (the f32 backward) every
// operand comes in its hi and lo parts, each part a head of its [2 bh,
// rows, D] map (head h's lo part at head h + bh), loaded side by side; each
// product is three bf16 products: S^T = K_hi.Q_hi^T + K_hi.Q_lo^T +
// K_lo.Q_hi^T (dP^T likewise), dV += P^T_hi.dO_hi + P^T_lo.dO_hi +
// P^T_hi.dO_lo (dK likewise).
template <int D, bool CAUSAL, int P>
__device__ __forceinline__ void bwd_dkv_body(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map, const CUtensorMap* do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int bh, int seq_q, int seq_k, float scale) {
  using Cfg = DkvCfg<D, P>;
  using It = typename Cfg::It;
  constexpr int BQ = Cfg::BQ, STAGES = Cfg::STAGES, DA = Cfg::DA, ROWS = It::ROWS;
  [[maybe_unused]] constexpr int TL = P == 1 ? 2 : 5;  // the stamps' kernel (RT_TIMELINE)
  extern __shared__ unsigned char dkv_smem[];
  bf16* ks = swizzle_base(dkv_smem);     // [P][D / BW][ROWS][BW]
  bf16* vs = ks + P * ROWS * D;          // [P][D / BW][ROWS][BW]
  bf16* qs = vs + P * ROWS * D;          // [STAGES][P][D / BW][BQ][BW]
  bf16* dos = qs + STAGES * P * BQ * D;  // [STAGES][P][D / BW][BQ][BW]
  float* stats = reinterpret_cast<float*>(dos + STAGES * P * BQ * D);  // [STAGES][lse | delta][BQ]
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      int it = 0, n = 0, head, k0;  // Q/dO tiles (the ring's position) and items loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_kt, head, k0); ++j, ++n) {
          mbar_wait(kv_empty, (n & 1) ^ 1);  // passes at once for the first item
          if (lane == 0) {
            mbar_expect_tx(kv_full, 2 * Cfg::KV_BYTES);
#pragma unroll
            for (int part = 0; part < P; ++part) {  // hi, then lo
              load_rows<ROWS, D>(ks + part * ROWS * D, k_map, kv_full, head + part * bh, k0);
              load_rows<ROWS, D>(vs + part * ROWS * D, v_map, kv_full, head + part * bh, k0);
            }
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
#pragma unroll
                for (int part = 0; part < P; ++part) {
                  load_rows<BQ, D>(qs + (st * P + part) * BQ * D, q_map, full, head + part * bh, qt * BQ);
                  load_rows<BQ, D>(dos + (st * P + part) * BQ * D, do_map, full, head + part * bh, qt * BQ);
                }
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t k_addr = smem_u32(ks) + It::row(wg) * Lay<D>::RB;
    const uint32_t v_addr = smem_u32(vs) + It::row(wg) * Lay<D>::RB;
    float s[BQ / 2], dp[BQ / 2], dka[DA / 2], dva[DA / 2];
    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
    auto q_addr = [&](int st) { return smem_u32(qs + st * P * BQ * D); };
    auto do_addr = [&](int st) { return smem_u32(dos + st * P * BQ * D); };
    auto keep_split = [&] {
      keep(p_hi);
      keep(p_lo);
      keep(ds_hi);
      keep(ds_lo);
    };
    // S^T = K.Q^T and dP^T = V.dO^T of the tile in stage st, issued (each
    // part's lo part one part's bytes past its hi part).
    auto issue_sdp = [&](int st) {
      if constexpr (P == 1) {
        issue_s<D, ROWS, true>(s, k_addr, q_addr(st));
        issue_s<D, ROWS, true>(dp, v_addr, do_addr(st));
      } else {
        issue_s_split<D, ROWS>(s, k_addr, q_addr(st), Cfg::KV_PART, Cfg::QT_PART);
        issue_s_split<D, ROWS>(dp, v_addr, do_addr(st), Cfg::KV_PART, Cfg::QT_PART);
      }
    };
    // The DA columns a pass makes: this warpgroup's columns, in passes.
    auto chunk = [&](int pass) { return It::col(wg) / DA + pass; };
    // dV += P^T.dO and dK += dS^T.Q of the tile in stage st, issued: the
    // DA columns of pass `pass` (dO's and Q's boxes from its first).
    auto issue_dkv = [&](int st, int pass) {
      const uint32_t at = chunk(pass) * (DA / Lay<D>::BW) * BQ * Lay<D>::RB;
      if constexpr (P == 1) {
        issue_pv<DA>(dva, p_hi, p_lo, do_addr(st) + at);
        issue_pv<DA>(dka, ds_hi, ds_lo, q_addr(st) + at);
      } else {
        issue_pv_split<DA>(dva, p_hi, p_lo, do_addr(st) + at, Cfg::QT_PART);
        issue_pv_split<DA>(dka, ds_hi, ds_lo, q_addr(st) + at, Cfg::QT_PART);
      }
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
                STAMP(TL, it + t, 0);
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
                STAMP(TL, it + t, 1);
                wgmma_wait<1>();  // S^T and dP^T of tile t are in
                keep(s);
                keep(dp);
                STAMP(TL, it + t, 2);
                mbar_arrive_if(kv_empty, tid == 0 && last && t + 1 == n_t);
                grads(st, (qt0 + t) * BQ, row0, r0);
                STAMP(TL, it + t, 3);
                wgmma_wait<0>();  // tile t-1's products are in: its stage and its split are free
                keep(dka);
                keep(dva);
                keep_split();
                STAMP(TL, it + t, 4);
                mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
                split();
                STAMP(TL, it + t, 5);
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

// B4 on bf16 operands.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dkv_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int bh, int seq_q, int seq_k, float scale) {
  bwd_dkv_body<D, CAUSAL, 1>(&q_map, &k_map, &v_map, &do_map, lse, delta, dk, dv, bh, seq_q, seq_k, scale);
}

// B4 on f32 operands given as split_kernel's parts (the f32 backward).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dkv_kernel_sm90_f32(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int bh, int seq_q, int seq_k, float scale) {
  bwd_dkv_body<D, CAUSAL, 2>(&q_map, &k_map, &v_map, &do_map, lse, delta, dk, dv, bh, seq_q, seq_k, scale);
}

// Persistent, in the forward's units of two 128-row q tiles. Per item the
// producer loads Q and dO once, then streams the K and V tiles up to the
// diagonal (kv_tiles). A consumer warpgroup owns 64 q rows: per K/V tile
// S = Q.K^T and dP = dO.V^T (SS), P and dS in registers (lse is known:
// nothing is rescaled), then dQ += dS_hi.K + dS_lo.K (RS, K MN-major, as V
// in the forward's P.V). With P = 2 (the f32 backward) the operands come
// in parts, as in bwd_dkv_body: S = Q_hi.K_hi^T + Q_hi.K_lo^T +
// Q_lo.K_hi^T (dP likewise) and dQ += dS_hi.K_hi + dS_lo.K_hi + dS_hi.K_lo.
template <int D, bool CAUSAL, int P>
__device__ __forceinline__ void bwd_dq_body(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map, const CUtensorMap* do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int bh,
    int seq_q, int seq_k, float scale) {
  using Cfg = DqCfg<D, P>;
  using It = typename Cfg::It;
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES, ROWS = It::ROWS, OUT = It::OUT;
  [[maybe_unused]] constexpr int TL = P == 1 ? 1 : 4;  // the stamps' kernel (RT_TIMELINE)
  extern __shared__ unsigned char dq_smem[];
  bf16* qs = swizzle_base(dq_smem);     // [P][D / BW][ROWS][BW]
  bf16* dos = qs + P * ROWS * D;        // [P][D / BW][ROWS][BW]
  bf16* ks = dos + P * ROWS * D;        // [STAGES][P][D / BW][BN][BW]
  bf16* vs = ks + STAGES * P * BN * D;  // [STAGES][P][D / BW][BN][BW]
  const uint32_t qdo_full = smem_u32(vs + STAGES * P * BN * D);  // the item's Q and dO landed
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0, n = 0, head, q0;  // K/V tiles (the ring's position) and items loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int j = 0; j < 2 && unit_item<ROWS>(u, j, n_qt, head, q0); ++j, ++n) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          mbar_wait(qdo_empty, (n & 1) ^ 1);  // passes at once for the first item
          mbar_expect_tx(qdo_full, 2 * Cfg::Q_BYTES);
#pragma unroll
          for (int part = 0; part < P; ++part) {  // hi, then lo
            load_rows<ROWS, D>(qs + part * ROWS * D, q_map, qdo_full, head + part * bh, q0);
            load_rows<ROWS, D>(dos + part * ROWS * D, do_map, qdo_full, head + part * bh, q0);
          }
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++it) {
            const int st = it % STAGES;
            mbar_wait(empty_bar + 8 * st, (it / STAGES & 1) ^ 1);  // passes at once on the first lap
            const uint32_t ring_full = full_bar + 8 * st;
            mbar_expect_tx(ring_full, 2 * Cfg::KV_BYTES);  // out-of-range rows are zero-filled and counted
#pragma unroll
            for (int part = 0; part < P; ++part) {
              load_rows<BN, D>(ks + (st * P + part) * BN * D, k_map, ring_full, head + part * bh, kt * BN);
              load_rows<BN, D>(vs + (st * P + part) * BN * D, v_map, ring_full, head + part * bh, kt * BN);
            }
          }
        }
    }
  } else {  // consumer warpgroup wg: q rows [q0 + row(wg), + 64) of each item, columns [col(wg), + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(qs) + It::row(wg) * Lay<D>::RB;
    const uint32_t do_addr = smem_u32(dos) + It::row(wg) * Lay<D>::RB;
    // This warpgroup's dQ columns of a K stage: its boxes, BN rows each.
    const uint32_t k_at = It::col(wg) / Lay<D>::BW * BN * Lay<D>::RB;
    float s[BN / 2], dp[BN / 2], dqa[OUT / 2];
    uint32_t ds_hi[BN / 16][4], ds_lo[BN / 16][4];
    auto k_addr = [&](int st) { return smem_u32(ks + st * P * BN * D); };
    // S = Q.K^T and dP = dO.V^T of the tile in stage st, issued (each lo
    // part one part's bytes past its hi part).
    auto issue_sdp = [&](int st) {
      if constexpr (P == 1) {
        issue_s<D, ROWS, true>(s, q_addr, k_addr(st));
        issue_s<D, ROWS, true>(dp, do_addr, smem_u32(vs + st * BN * D));
      } else {
        issue_s_split<D, ROWS>(s, q_addr, k_addr(st), Cfg::Q_PART, Cfg::KV_PART);
        issue_s_split<D, ROWS>(dp, do_addr, smem_u32(vs + st * P * BN * D), Cfg::Q_PART, Cfg::KV_PART);
      }
    };
    // dQ += dS.K of the tile in stage st, issued: this warpgroup's columns.
    auto issue_dq = [&](int st) {
      if constexpr (P == 1)
        issue_pv<OUT>(dqa, ds_hi, ds_lo, k_addr(st) + k_at);
      else
        issue_pv_split<OUT>(dqa, ds_hi, ds_lo, k_addr(st) + k_at, Cfg::KV_PART);
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
          STAMP(TL, it + kt, 0);
          bar_sync(1 + wg);
          keep(dqa);
          keep(ds_hi);
          keep(ds_lo);
          wgmma_fence();
          issue_sdp(st);
          wgmma_commit();
          issue_dq(prev);
          wgmma_commit();
          keep(s);
          keep(dp);
          keep(dqa);
          STAMP(TL, it + kt, 1);
          bar_arrive_if(2 - wg, wg == 0 || kt + 1 < n_kv_tiles);
          wgmma_wait<1>();  // S and dP of tile kt are in
          keep(s);
          keep(dp);
          STAMP(TL, it + kt, 2);
          mbar_arrive_if(qdo_empty, tid == 0 && kt + 1 == n_kv_tiles);
          grads(kt * BN);
          STAMP(TL, it + kt, 3);
          wgmma_wait<0>();  // tile kt-1's product is in: its stage and its split are free
          keep(dqa);
          keep(ds_hi);
          keep(ds_lo);
          STAMP(TL, it + kt, 4);
          mbar_arrive_if(empty_bar + 8 * prev, tid == 0);
          split_p<true>(dp, ds_hi, ds_lo);
          STAMP(TL, it + kt, 5);
        }
        it += n_kv_tiles;
        keep(dqa);
        keep(ds_hi);
        keep(ds_lo);
        wgmma_fence();
        issue_dq(st);
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

// B3 on bf16 operands.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dq_kernel_sm90(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int bh,
    int seq_q, int seq_k, float scale) {
  bwd_dq_body<D, CAUSAL, 1>(&q_map, &k_map, &v_map, &do_map, lse, delta, dq, bh, seq_q, seq_k, scale);
}

// B3 on f32 operands given as split_kernel's parts (the f32 backward).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dq_kernel_sm90_f32(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int bh,
    int seq_q, int seq_k, float scale) {
  bwd_dq_body<D, CAUSAL, 2>(&q_map, &k_map, &v_map, &do_map, lse, delta, dq, bh, seq_q, seq_k, scale);
}

// ======================= backward on Hopper, S's and dP's contraction streamed
//
// bwd_dq_kernel_sm90_stream replaces _attn_bwd_dq_kernel (B3) and
// bwd_dkv_kernel_sm90_stream _attn_bwd_dkv_kernel (B4) of
// ray_tpu/ops/flash_attention.py where an item's resident operands no
// longer fit beside a stream of tiles: bf16 (P = 1) past D = 512, f32 as
// split_kernel's parts (P = 2) at 512 and past, D a runtime multiple of
// STREAM_SLICE. See the file's header ("The backward past 512") for the
// design.

// Tiles and shared memory of bwd_dq_kernel_sm90_stream, in bytes. An item is
// 64 q rows by one slice of STREAM_SLICE dQ columns. An S stage holds, for
// one chunk of G columns (StreamCfg's), the item's Q and dO chunks and a K/V
// tile's K and V chunks, each in P parts ([P][G / 64][rows][64]); the ring
// is S_STAGES deep. dQ += dS.K takes the slice's columns of the K tile (BN
// keys x 512 x P) from a ring of K_STAGES of its own. P = 1: 32-key tiles,
// 3 x 48 + 2 x 32 = 208 KB; P = 2: 16-key tiles, 4 x 40 + 2 x 32 = 224 KB.
template <int P>
struct DqStreamCfg {
  static constexpr int ROWS = 64, BN = P == 1 ? 32 : 16, G = StreamCfg<P>::G;
  static constexpr int S_STAGES = P == 1 ? 3 : 4, K_STAGES = 2;
  static constexpr int A_PART = ROWS * G * 2, B_PART = BN * G * 2;  // one part of a Q or dO, a K or V chunk
  static constexpr int DO_AT = P * A_PART, K_AT = 2 * DO_AT, V_AT = K_AT + P * B_PART;  // in an S stage
  static constexpr int S_BYTES = 2 * P * (A_PART + B_PART);
  static constexpr int K_PART = BN * STREAM_SLICE * 2, K_BYTES = P * K_PART;  // one K slice stage
  static constexpr int RING_AT = S_STAGES * S_BYTES, BAR_AT = RING_AT + K_STAGES * K_BYTES;
  static constexpr int BYTES = BAR_AT + 8 * 2 * (S_STAGES + K_STAGES) + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  // The producer's loop over chunks, parts and boxes keeps its counters in
  // 40 registers; the consumers keep 232.
  static constexpr int PRODUCER_REGS = 40;
};

// Tiles and shared memory of bwd_dkv_kernel_sm90_stream, in bytes. An item
// is 64 k rows by one slice of SLICE columns of dK and dV. An S stage holds
// the item's K and V chunks and a Q/dO tile's Q and dO chunks (BQ rows);
// dK += dS^T.Q and dV += P^T.dO take the slice's columns of the tile's Q and
// dO ([P][SLICE / 64][BQ][64] each) from a ring of Q_STAGES; the tile's lse
// and delta lie in slots past everything, one [lse | delta] pair a slice
// stage. 4 x 40 + 2 x 16 = 192 KB at P = 1, 4 x 40 + 2 x 32 = 224 KB at P = 2.
template <int P>
struct DkvStreamCfg {
  static constexpr int ROWS = 64, BQ = 16, G = StreamCfg<P>::G, SLICE = STREAM_SLICE / 2;
  static constexpr int S_STAGES = 4, Q_STAGES = 2;
  static constexpr int A_PART = ROWS * G * 2, B_PART = BQ * G * 2;  // one part of a K or V, a Q or dO chunk
  static constexpr int V_AT = P * A_PART, Q_AT = 2 * V_AT, DO_AT = Q_AT + P * B_PART;  // in an S stage
  static constexpr int S_BYTES = 2 * P * (A_PART + B_PART);
  static constexpr int Q_PART = BQ * SLICE * 2;  // one part of a Q or dO slice
  static constexpr int DO_SLICE_AT = P * Q_PART, Q_BYTES = 2 * P * Q_PART;  // in a slice stage
  static constexpr int RING_AT = S_STAGES * S_BYTES, BAR_AT = RING_AT + Q_STAGES * Q_BYTES;
  static constexpr int STAT_AT = BAR_AT + 8 * 2 * (S_STAGES + Q_STAGES);
  static constexpr int BYTES = STAT_AT + Q_STAGES * 2 * BQ * 4 + 1024;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
  static constexpr int PRODUCER_REGS = 40;
};

// Persistent, in units of two 64-row q tiles of one head (unit_item), once
// for each slice of dQ's columns, slice fastest. For each K/V tile of an
// item (up to the diagonal: kv_tiles) the producer's one thread loads its
// n_ch chunk stages, then the slice's columns of K. Both consumer
// warpgroups make S and dP for the item's 64 rows over all chunks (chunk c
// issued once its stage has landed, its stage freed once its products are
// in), then dS from lse and delta (P is not kept: nothing is rescaled), and
// dQ += dS.K for their 256 of the slice's columns, tile t-1's under tile
// t's dS, as bwd_dq_body. With P = 2 each product is three bf16 products.
template <int P, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dq_kernel_sm90_stream(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int bh,
    int seq_q, int seq_k, int D, float scale) {
  using Cfg = DqStreamCfg<P>;
  constexpr int ROWS = Cfg::ROWS, BN = Cfg::BN, G = Cfg::G, SS = Cfg::S_STAGES, KS = Cfg::K_STAGES;
  constexpr int OUT = STREAM_SLICE / 2;  // a warpgroup's dQ columns
  extern __shared__ unsigned char dq_stream_smem[];
  const uint32_t sm = smem_u32(swizzle_base(dq_stream_smem));
  const uint32_t s_full = sm + Cfg::BAR_AT;  // [SS]: the stage's chunks landed
  const uint32_t s_empty = s_full + 8 * SS;  // [SS]: both consumers' products of it are in
  const uint32_t k_full = s_empty + 8 * SS;  // [KS]: the stage's K slice landed
  const uint32_t k_empty = k_full + 8 * KS;  // [KS]: both consumers' dQ products of it are in
  auto s_at = [&](int i) { return sm + i % SS * Cfg::S_BYTES; };
  auto k_at = [&](int i) { return sm + Cfg::RING_AT + i % KS * Cfg::K_BYTES; };

  const int n_ch = D / G, n_slices = D / STREAM_SLICE;
  const int n_qt = (seq_q + ROWS - 1) / ROWS, n_units = (n_qt + 1) / 2 * bh * n_slices;
  if (threadIdx.x == 0) {
    for (int st = 0; st < SS; ++st) {
      mbar_init(s_full + 8 * st, 1);
      mbar_init(s_empty + 8 * st, 2);
    }
    for (int st = 0; st < KS; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one thread keeps both rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int is = 0, ik = 0, head, q0;  // S stages and K slices loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int slice = u % n_slices;
        for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_qt, head, q0); ++j) {
          const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
          for (int kt = 0; kt < n_kv_tiles; ++kt, ++ik) {
            const int k0 = kt * BN;
            for (int c = 0; c < n_ch; ++c, ++is) {
              const uint32_t st = s_at(is), full = s_full + 8 * (is % SS);
              mbar_wait(s_empty + 8 * (is % SS), (is / SS & 1) ^ 1);  // passes at once on the first lap
              mbar_expect_tx(full, Cfg::S_BYTES);  // out-of-range rows are zero-filled and counted
              for (int part = 0; part < P; ++part)
                for (int b = 0; b < G / 64; ++b) {
                  const int col = c * G + 64 * b, h = head + part * bh;
                  const uint32_t a = part * Cfg::A_PART + b * ROWS * 128, k = part * Cfg::B_PART + b * BN * 128;
                  tma_load_at(st + a, &q_map, full, col, q0, h);
                  tma_load_at(st + Cfg::DO_AT + a, &do_map, full, col, q0, h);
                  tma_load_at(st + Cfg::K_AT + k, &k_map, full, col, k0, h);
                  tma_load_at(st + Cfg::V_AT + k, &v_map, full, col, k0, h);
                }
            }
            const uint32_t full = k_full + 8 * (ik % KS);
            mbar_wait(k_empty + 8 * (ik % KS), (ik / KS & 1) ^ 1);
            mbar_expect_tx(full, Cfg::K_BYTES);
            for (int part = 0; part < P; ++part)
              for (int b = 0; b < STREAM_SLICE / 64; ++b)
                tma_load_at(k_at(ik) + (part * STREAM_SLICE / 64 + b) * BN * 128, &k_map, full,
                            slice * STREAM_SLICE + 64 * b, k0, head + part * bh);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: the item's 64 rows, the slice's dQ columns [OUT wg, OUT wg + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t k_col = wg * (OUT / 64) * BN * 128;  // this warpgroup's boxes of a K slice part
    float s[BN / 2], dp[BN / 2], dqa[OUT / 2];
    uint32_t dsh[BN / 16][4], dsl[BN / 16][4];

    // S and dP of one tile over its n_ch chunks (stage `is` on): every
    // chunk's products but the last are in on return, their stages freed;
    // the last chunk's are one commit group in flight, its stage held.
    auto issue_sdp_tile = [&](int is) {
      mbar_wait(s_full + 8 * (is % SS), is / SS & 1);
      issue_s_chunk<P, true>(s, s_at(is), s_at(is) + Cfg::K_AT);
      issue_s_chunk<P, true>(dp, s_at(is) + Cfg::DO_AT, s_at(is) + Cfg::V_AT);
      wgmma_commit();
      keep(s);
      keep(dp);
      for (int c = 1; c < n_ch; ++c) {
        const int i = is + c;
        mbar_wait(s_full + 8 * (i % SS), i / SS & 1);
        issue_s_chunk<P, false>(s, s_at(i), s_at(i) + Cfg::K_AT);
        issue_s_chunk<P, false>(dp, s_at(i) + Cfg::DO_AT, s_at(i) + Cfg::V_AT);
        wgmma_commit();
        keep(s);
        keep(dp);
        wgmma_wait<1>();  // chunk c - 1's products are in: its stage is free
        keep(s);
        keep(dp);
        mbar_arrive_if(s_empty + 8 * ((i - 1) % SS), tid == 0);
      }
    };
    // dQ += dS.K of the tile whose K slice is stage ik, issued.
    auto issue_dq_tile = [&](int ik) {
      mbar_wait(k_full + 8 * (ik % KS), ik / KS & 1);
      if constexpr (P == 1)
        issue_pv<OUT>(dqa, dsh, dsl, k_at(ik) + k_col);
      else
        issue_pv_split<OUT>(dqa, dsh, dsl, k_at(ik) + k_col, Cfg::K_PART);
      wgmma_commit();
    };

    int is = 0, ik = 0, head, q0;  // S stages and K slices consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int slice = u % n_slices;
      for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_qt, head, q0); ++j) {
        const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);
        const int r0 = q0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
        float lse2[2], dl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r;
          const size_t at = static_cast<size_t>(head) * seq_q + qp;
          lse2[r] = qp < seq_q ? lse[at] * LOG2E : 0.f;
          dl[r] = qp < seq_q ? delta[at] : 0.f;
        }
        // dS / scale of the tile at k0 in place of dP. Only a tile on the
        // diagonal or past seq_k has masked entries.
        auto grads = [&](int k0) {
          if (k0 + BN > seq_k || (CAUSAL && k0 + BN - 1 > q0))
            dq_grads<true, CAUSAL>(s, dp, lse2, dl, r0, k0 + 2 * tg, seq_k, sl2);
          else
            dq_grads<false, CAUSAL>(s, dp, lse2, dl, r0, k0 + 2 * tg, seq_k, sl2);
        };
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dqa[i] = 0.f;
        // Tile 0: S_0 and dP_0 alone.
        keep(s);
        keep(dp);
        wgmma_fence();
        issue_sdp_tile(is);
        is += n_ch;
        wgmma_wait<0>();
        keep(s);
        keep(dp);
        mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
        grads(0);
        split_p<true>(dp, dsh, dsl);
        // Tile kt: S_kt and dP_kt chunk by chunk, then dQ += dS_{kt-1}.K_{kt-1},
        // which runs on the tensor cores under tile kt's dS.
        for (int kt = 1; kt < n_kv_tiles; ++kt, ++ik) {
          STAMP(7, ik, 0);
          keep(s);
          keep(dp);
          keep(dqa);
          keep(dsh);
          keep(dsl);
          wgmma_fence();
          issue_sdp_tile(is);
          is += n_ch;
          STAMP(7, ik, 1);
          issue_dq_tile(ik);
          STAMP(7, ik, 2);
          keep(s);
          keep(dp);
          keep(dqa);
          wgmma_wait<1>();  // S_kt and dP_kt are in: their last chunk's stage is free
          keep(s);
          keep(dp);
          STAMP(7, ik, 3);
          mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
          grads(kt * BN);
          STAMP(7, ik, 4);
          wgmma_wait<0>();  // tile kt-1's dQ product is in: its split and its K slice are free
          keep(dqa);
          keep(dsh);
          keep(dsl);
          mbar_arrive_if(k_empty + 8 * (ik % KS), tid == 0);
          split_p<true>(dp, dsh, dsl);
          STAMP(7, ik, 5);
        }
        keep(dqa);
        keep(dsh);
        keep(dsl);
        wgmma_fence();
        issue_dq_tile(ik);
        keep(dqa);
        wgmma_wait<0>();
        keep(dqa);
        keep(dsh);
        keep(dsl);
        mbar_arrive_if(k_empty + 8 * (ik % KS), tid == 0);
        ++ik;
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dqa[i] *= scale;
        store_rows<OUT>(dq + static_cast<size_t>(head) * seq_q * D + slice * STREAM_SLICE + wg * OUT, dqa, r0, tg,
                        seq_q, D);
      }
    }
  }
}

// Persistent, in units of two 64-row k tiles of one head (unit_item), once
// for each slice of dK's and dV's columns, slice fastest. For each Q/dO
// tile that sees an item (with CAUSAL from its diagonal's, the reference's
// skip) the producer warp's lane 0 loads its n_ch chunk stages, then the
// slice's columns of Q and dO, and its 32 lanes copy the tile's lse and
// delta into the slice stage's slots (cp.async, zero past T). Both consumer
// warpgroups make S^T = K.Q^T and dP^T = V.dO^T for the item's 64 k rows
// over all chunks, then P^T and dS^T (dkv_grads), and dV += P^T.dO, dK +=
// dS^T.Q for their 128 of the slice's columns, tile t-1's under tile t's
// P^T and dS^T. With P = 2 each product is three bf16 products.
template <int P, bool CAUSAL>
__global__ void __launch_bounds__(FWD_THREADS, 1) bwd_dkv_kernel_sm90_stream(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int bh, int seq_q, int seq_k, int D, float scale) {
  using Cfg = DkvStreamCfg<P>;
  constexpr int ROWS = Cfg::ROWS, BQ = Cfg::BQ, G = Cfg::G, SS = Cfg::S_STAGES, QS = Cfg::Q_STAGES;
  constexpr int SLICE = Cfg::SLICE, OUT = SLICE / 2;  // a warpgroup's dK and dV columns
  extern __shared__ unsigned char dkv_stream_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(swizzle_base(dkv_stream_smem));
  const uint32_t sm = smem_u32(base);
  float* stats = reinterpret_cast<float*>(base + Cfg::STAT_AT);  // [QS][lse | delta][BQ]
  const uint32_t s_full = sm + Cfg::BAR_AT;  // [SS]: the stage's chunks landed
  const uint32_t s_empty = s_full + 8 * SS;  // [SS]: both consumers' products of it are in
  const uint32_t q_full = s_empty + 8 * SS;  // [QS]: the stage's Q and dO slices and stats landed
  const uint32_t q_empty = q_full + 8 * QS;  // [QS]: both consumers' dK and dV products of it are in
  auto s_at = [&](int i) { return sm + i % SS * Cfg::S_BYTES; };
  auto q_at = [&](int i) { return sm + Cfg::RING_AT + i % QS * Cfg::Q_BYTES; };

  const int n_ch = D / G, n_slices = D / SLICE;
  const int n_kt = (seq_k + ROWS - 1) / ROWS, n_units = (n_kt + 1) / 2 * bh * n_slices;
  const int q_tiles = (seq_q + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    for (int st = 0; st < SS; ++st) {
      mbar_init(s_full + 8 * st, 1);
      mbar_init(s_empty + 8 * st, 2);
    }
    for (int st = 0; st < QS; ++st) {
      mbar_init(q_full + 8 * st, 1 + 32);  // the TMA's arrival and one per producer lane's cp.asyncs
      mbar_init(q_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: one warp; lane 0 issues the TMA loads, every lane copies stats
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Cfg::PRODUCER_REGS));
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      int is = 0, iq = 0, head, k0;  // S stages and Q/dO slices loaded
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int slice = u % n_slices;
        for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_kt, head, k0); ++j) {
          const float* lse_h = lse + static_cast<size_t>(head) * seq_q;
          const float* delta_h = delta + static_cast<size_t>(head) * seq_q;
          for (int q0 = CAUSAL ? k0 / BQ * BQ : 0; q0 < q_tiles * BQ; q0 += BQ, ++iq) {
            for (int c = 0; c < n_ch; ++c, ++is) {
              const uint32_t st = s_at(is), full = s_full + 8 * (is % SS);
              mbar_wait(s_empty + 8 * (is % SS), (is / SS & 1) ^ 1);  // passes at once on the first lap
              if (lane == 0) {
                mbar_expect_tx(full, Cfg::S_BYTES);  // out-of-range rows are zero-filled and counted
                for (int part = 0; part < P; ++part)
                  for (int b = 0; b < G / 64; ++b) {
                    const int col = c * G + 64 * b, h = head + part * bh;
                    const uint32_t a = part * Cfg::A_PART + b * ROWS * 128, t = part * Cfg::B_PART + b * BQ * 128;
                    tma_load_at(st + a, &k_map, full, col, k0, h);
                    tma_load_at(st + Cfg::V_AT + a, &v_map, full, col, k0, h);
                    tma_load_at(st + Cfg::Q_AT + t, &q_map, full, col, q0, h);
                    tma_load_at(st + Cfg::DO_AT + t, &do_map, full, col, q0, h);
                  }
              }
            }
            const uint32_t full = q_full + 8 * (iq % QS);
            mbar_wait(q_empty + 8 * (iq % QS), (iq / QS & 1) ^ 1);
            if (lane == 0) {
              mbar_expect_tx(full, Cfg::Q_BYTES);
              for (int part = 0; part < P; ++part)
                for (int b = 0; b < SLICE / 64; ++b) {
                  const int col = slice * SLICE + 64 * b, h = head + part * bh;
                  const uint32_t at = q_at(iq) + (part * SLICE / 64 + b) * BQ * 128;
                  tma_load_at(at, &q_map, full, col, q0, h);
                  tma_load_at(at + Cfg::DO_SLICE_AT, &do_map, full, col, q0, h);
                }
            }
            // lse and delta rows are 4 * T bytes apart, no multiple of 16 for
            // every T: cp.async, zero-filled past T.
            float* stat = stats + iq % QS * 2 * BQ;
            const int qp = q0 + lane;
            if (lane < BQ) {
              cp_async_4(stat + lane, lse_h + (qp < seq_q ? qp : 0), qp < seq_q);
              cp_async_4(stat + BQ + lane, delta_h + (qp < seq_q ? qp : 0), qp < seq_q);
            }
            cp_async_arrive(full);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: the item's 64 k rows, the slice's columns [OUT wg, OUT wg + OUT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240 - (Cfg::PRODUCER_REGS - 24) / 2));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tg = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint32_t q_col = wg * (OUT / 64) * BQ * 128;  // this warpgroup's boxes of a Q or dO slice part
    float s[BQ / 2], dp[BQ / 2], dka[OUT / 2], dva[OUT / 2];
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dsh[BQ / 16][4], dsl[BQ / 16][4];

    // S^T and dP^T of one Q/dO tile over its n_ch chunks, as bwd_dq's.
    auto issue_sdp_tile = [&](int is) {
      mbar_wait(s_full + 8 * (is % SS), is / SS & 1);
      issue_s_chunk<P, true>(s, s_at(is), s_at(is) + Cfg::Q_AT);
      issue_s_chunk<P, true>(dp, s_at(is) + Cfg::V_AT, s_at(is) + Cfg::DO_AT);
      wgmma_commit();
      keep(s);
      keep(dp);
      for (int c = 1; c < n_ch; ++c) {
        const int i = is + c;
        mbar_wait(s_full + 8 * (i % SS), i / SS & 1);
        issue_s_chunk<P, false>(s, s_at(i), s_at(i) + Cfg::Q_AT);
        issue_s_chunk<P, false>(dp, s_at(i) + Cfg::V_AT, s_at(i) + Cfg::DO_AT);
        wgmma_commit();
        keep(s);
        keep(dp);
        wgmma_wait<1>();  // chunk c - 1's products are in: its stage is free
        keep(s);
        keep(dp);
        mbar_arrive_if(s_empty + 8 * ((i - 1) % SS), tid == 0);
      }
    };
    // dV += P^T.dO and dK += dS^T.Q of the tile whose slices are stage iq, issued.
    auto issue_dkv_tile = [&](int iq) {
      const uint32_t at = q_at(iq) + q_col;
      if constexpr (P == 1) {
        issue_pv<OUT>(dva, ph, pl, at + Cfg::DO_SLICE_AT);
        issue_pv<OUT>(dka, dsh, dsl, at);
      } else {
        issue_pv_split<OUT>(dva, ph, pl, at + Cfg::DO_SLICE_AT, Cfg::Q_PART);
        issue_pv_split<OUT>(dka, dsh, dsl, at, Cfg::Q_PART);
      }
      wgmma_commit();
    };
    auto split_pds = [&] {
      split_p<true>(s, ph, pl);
      split_p<true>(dp, dsh, dsl);
    };
    auto keep_split = [&] {
      keep(ph);
      keep(pl);
      keep(dsh);
      keep(dsl);
    };

    int is = 0, iq = 0, head, k0;  // S stages and Q/dO slices consumed
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int slice = u % n_slices;
      for (int j = 0; j < 2 && unit_item<ROWS>(u / n_slices, j, n_kt, head, k0); ++j) {
        const int r0 = k0 + warp * 16 + lane / 4;  // this thread's k rows: r0 and r0 + 8
        const int first = CAUSAL ? k0 / BQ * BQ : 0, n_t = max(q_tiles - first / BQ, 0);
        // P^T and dS^T / scale of the tile at q0 (its stats in slice stage
        // `stage`) in place of S^T and dP^T, once the stage has landed. Only a
        // tile that crosses the diagonal or the end of T or S has masked
        // entries.
        auto grads = [&](int stage, int q0) {
          mbar_wait(q_full + 8 * (stage % QS), stage / QS & 1);
          const float* stat = stats + stage % QS * 2 * BQ;
          if (q0 + BQ > seq_q || k0 + ROWS > seq_k || (CAUSAL && q0 < k0 + ROWS - 1))
            dkv_grads<true, CAUSAL>(s, dp, stat, q0, r0, tg, seq_q, seq_k, sl2);
          else
            dkv_grads<false, CAUSAL>(s, dp, stat, q0, r0, tg, seq_q, seq_k, sl2);
        };
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dka[i] = dva[i] = 0.f;
        if (n_t > 0) {
          // Tile 0: S^T_0 and dP^T_0 alone.
          keep(s);
          keep(dp);
          wgmma_fence();
          issue_sdp_tile(is);
          is += n_ch;
          wgmma_wait<0>();
          keep(s);
          keep(dp);
          mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
          grads(iq, first);
          split_pds();
          // Tile t: S^T_t and dP^T_t chunk by chunk, then tile t-1's dV and
          // dK products, which run under tile t's P^T and dS^T.
          for (int t = 1; t < n_t; ++t, ++iq) {
            STAMP(8, iq, 0);
            keep(s);
            keep(dp);
            keep(dka);
            keep(dva);
            keep_split();
            wgmma_fence();
            issue_sdp_tile(is);
            is += n_ch;
            STAMP(8, iq, 1);
            issue_dkv_tile(iq);
            STAMP(8, iq, 2);
            keep(s);
            keep(dp);
            keep(dka);
            keep(dva);
            wgmma_wait<1>();  // S^T_t and dP^T_t are in: their last chunk's stage is free
            keep(s);
            keep(dp);
            STAMP(8, iq, 3);
            mbar_arrive_if(s_empty + 8 * ((is - 1) % SS), tid == 0);
            grads(iq + 1, first + t * BQ);
            STAMP(8, iq, 4);
            wgmma_wait<0>();  // tile t-1's products are in: its split and its slices are free
            keep(dka);
            keep(dva);
            keep_split();
            mbar_arrive_if(q_empty + 8 * (iq % QS), tid == 0);
            split_pds();
            STAMP(8, iq, 5);
          }
          keep(dka);
          keep(dva);
          keep_split();
          wgmma_fence();
          issue_dkv_tile(iq);
          keep(dka);
          keep(dva);
          wgmma_wait<0>();
          keep(dka);
          keep(dva);
          keep_split();
          mbar_arrive_if(q_empty + 8 * (iq % QS), tid == 0);
          ++iq;
        }
        const size_t at = static_cast<size_t>(head) * seq_k * D + slice * SLICE + wg * OUT;
#pragma unroll
        for (int i = 0; i < OUT / 2; ++i) dka[i] *= scale;
        store_rows<OUT>(dk + at, dka, r0, tg, seq_k, D);
        store_rows<OUT>(dv + at, dva, r0, tg, seq_k, D);
      }
    }
  }
}

// ---------------------------------------------------------------- launchers

// Every kernel takes more than the default 48 KB of shared memory, which a
// kernel is allowed only once its limit is raised on the device. Raise it at
// the kernel's first launch on each device, not at every launch: the smem
// size of one instantiation is fixed. THREADS is the kernel's block size.
template <auto Kernel, int THREADS, typename... Args>
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
// `bw` columns (64: the 128-byte swizzle; 32: the 64-byte one, Lay) by
// box_rows rows of one head. A box's rows past `rows` are zero-filled: they
// never come from the next head. TMA needs the base 16-byte aligned and
// every stride a multiple of 16 bytes: the wrapper checks the first, and D
// in {32, 64, 96, 128, 256} or a multiple of 512 gives the second.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int heads, int rows, int D, int bw, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {cuuint32_t(bw), cuuint32_t(box_rows), 1}, unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// encode_map at a width the Hopper kernels are built for, in Lay<D>'s boxes.
template <int D>
cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int heads, int rows, int box_rows) {
  return encode_map(map, ptr, heads, rows, D, Lay<D>::BW, box_rows);
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

// q, k and v are split_kernel's parts, each [2 bh, rows, D] bf16 (the hi
// part of head h at head h, its lo part at head h + bh); o is f32. The maps'
// head coordinate is an int: bh up to 2^30 - 1.
template <int D>
cudaError_t fwd_sm90_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                         int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  if (bh > 0x3FFFFFFF) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, 2 * bh, seq_q, FWD_BQ);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, 2 * bh, seq_k, F32FwdCfg<D>::BN);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, 2 * bh, seq_k, F32FwdCfg<D>::BN);
  if (err == cudaSuccess) err = units_of<FWD_BQ>(seq_q, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = F32FwdCfg<D>::BYTES;
  float* ot = static_cast<float*>(o);
  if (causal) {
    return lse ? launch<fwd_kernel_sm90_f32<D, true, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                          lse, bh, seq_q, seq_k, scale)
               : launch<fwd_kernel_sm90_f32<D, true, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm,
                                                                           ot, lse, bh, seq_q, seq_k, scale);
  }
  return lse ? launch<fwd_kernel_sm90_f32<D, false, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                         lse, bh, seq_q, seq_k, scale)
             : launch<fwd_kernel_sm90_f32<D, false, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm, ot,
                                                                          lse, bh, seq_q, seq_k, scale);
}

// fwd_kernel_sm90_stream on operands in P parts (P = 1: bf16, o bf16; P = 2:
// split_kernel's parts, [2 bh, rows, D] each, o f32) at any D that is a
// multiple of STREAM_SLICE; an int counts the units, the slices included.
template <int P>
cudaError_t fwd_sm90_stream(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                            int seq_q, int seq_k, int D, float scale, bool causal, cudaStream_t stream) {
  using Cfg = StreamCfg<P>;
  if (D <= 0 || D % STREAM_SLICE || bh > 0x7FFFFFFF / P) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_map(&qm, q, P * bh, seq_q, D, 64, Cfg::ROWS);
  if (err == cudaSuccess) err = encode_map(&km, k, P * bh, seq_k, D, 64, Cfg::BN);
  if (err == cudaSuccess) err = encode_map(&vm, v, P * bh, seq_k, D, 64, Cfg::BN);
  if (err == cudaSuccess) err = units_of<Cfg::ROWS>(seq_q, bh, units);
  if (err == cudaSuccess && units > 0x7FFFFFFF / (D / STREAM_SLICE)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = persistent_grid(units * (D / STREAM_SLICE), grid);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg::BYTES;
  if (causal) {
    return lse ? launch<fwd_kernel_sm90_stream<P, true, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, o,
                                                                             lse, bh, seq_q, seq_k, D, scale)
               : launch<fwd_kernel_sm90_stream<P, true, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm, o,
                                                                              lse, bh, seq_q, seq_k, D, scale);
  }
  return lse ? launch<fwd_kernel_sm90_stream<P, false, true>, FWD_THREADS>(grid, smem, stream, qm, km, vm, o,
                                                                            lse, bh, seq_q, seq_k, D, scale)
             : launch<fwd_kernel_sm90_stream<P, false, false>, FWD_THREADS>(grid, smem, stream, qm, km, vm, o,
                                                                             lse, bh, seq_q, seq_k, D, scale);
}

// The Hopper backward kernels on operands in P parts: P = 1, bf16; P = 2,
// split_kernel's parts, each operand a [2 bh, rows, D] bf16 tensor (the hi
// part of head h at head h, its lo part at head h + bh; bh up to 2^30 - 1,
// as the maps' head coordinate is an int).
template <int D, int P>
cudaError_t bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, float* dk, float* dv, int bh,
                         int seq_q, int seq_k, float scale, bool causal, cudaStream_t stream) {
  using Cfg = DkvCfg<D, P>;
  constexpr int ROWS = Cfg::It::ROWS;
  if (bh > 0x7FFFFFFF / P) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, P * bh, seq_q, Cfg::BQ);
  if (err == cudaSuccess) err = encode_rows<D>(&dom, dout, P * bh, seq_q, Cfg::BQ);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, P * bh, seq_k, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, P * bh, seq_k, ROWS);
  if (err == cudaSuccess) err = units_of<ROWS>(seq_k, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg::BYTES;
  if constexpr (P == 2)
    return causal ? launch<bwd_dkv_kernel_sm90_f32<D, true>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale)
                  : launch<bwd_dkv_kernel_sm90_f32<D, false>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale);
  else
    return causal ? launch<bwd_dkv_kernel_sm90<D, true>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale)
                  : launch<bwd_dkv_kernel_sm90<D, false>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, scale);
}

template <int D, int P>
cudaError_t bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, int bh, int seq_q,
                        int seq_k, float scale, bool causal, cudaStream_t stream) {
  using Cfg = DqCfg<D, P>;
  constexpr int ROWS = Cfg::It::ROWS;
  if (bh > 0x7FFFFFFF / P) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_rows<D>(&qm, q, P * bh, seq_q, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&dom, dout, P * bh, seq_q, ROWS);
  if (err == cudaSuccess) err = encode_rows<D>(&km, k, P * bh, seq_k, Cfg::BN);
  if (err == cudaSuccess) err = encode_rows<D>(&vm, v, P * bh, seq_k, Cfg::BN);
  if (err == cudaSuccess) err = units_of<ROWS>(seq_q, bh, units);
  if (err == cudaSuccess) err = persistent_grid(units, grid);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg::BYTES;
  if constexpr (P == 2)
    return causal ? launch<bwd_dq_kernel_sm90_f32<D, true>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale)
                  : launch<bwd_dq_kernel_sm90_f32<D, false>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale);
  else
    return causal ? launch<bwd_dq_kernel_sm90<D, true>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale)
                  : launch<bwd_dq_kernel_sm90<D, false>, FWD_THREADS>(
                        grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, scale);
}

// The streamed backward kernels on operands in P parts (P = 1: bf16; P = 2:
// split_kernel's parts, [2 bh, rows, D] each) at any D that is a multiple
// of STREAM_SLICE; an int counts the units, the slices included.
template <int P>
cudaError_t bwd_dq_sm90_stream(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                               const float* delta, float* dq, int bh, int seq_q, int seq_k, int D, float scale,
                               bool causal, cudaStream_t stream) {
  using Cfg = DqStreamCfg<P>;
  if (D <= 0 || D % STREAM_SLICE || bh > 0x7FFFFFFF / P) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_map(&qm, q, P * bh, seq_q, D, 64, Cfg::ROWS);
  if (err == cudaSuccess) err = encode_map(&dom, dout, P * bh, seq_q, D, 64, Cfg::ROWS);
  if (err == cudaSuccess) err = encode_map(&km, k, P * bh, seq_k, D, 64, Cfg::BN);
  if (err == cudaSuccess) err = encode_map(&vm, v, P * bh, seq_k, D, 64, Cfg::BN);
  if (err == cudaSuccess) err = units_of<Cfg::ROWS>(seq_q, bh, units);
  if (err == cudaSuccess && units > 0x7FFFFFFF / (D / STREAM_SLICE)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = persistent_grid(units * (D / STREAM_SLICE), grid);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg::BYTES;
  return causal ? launch<bwd_dq_kernel_sm90_stream<P, true>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, D, scale)
                : launch<bwd_dq_kernel_sm90_stream<P, false>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dq, bh, seq_q, seq_k, D, scale);
}

template <int P>
cudaError_t bwd_dkv_sm90_stream(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                const float* delta, float* dk, float* dv, int bh, int seq_q, int seq_k, int D,
                                float scale, bool causal, cudaStream_t stream) {
  using Cfg = DkvStreamCfg<P>;
  if (D <= 0 || D % STREAM_SLICE || bh > 0x7FFFFFFF / P) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  dim3 grid;
  int units = 0;
  cudaError_t err = encode_map(&qm, q, P * bh, seq_q, D, 64, Cfg::BQ);
  if (err == cudaSuccess) err = encode_map(&dom, dout, P * bh, seq_q, D, 64, Cfg::BQ);
  if (err == cudaSuccess) err = encode_map(&km, k, P * bh, seq_k, D, 64, Cfg::ROWS);
  if (err == cudaSuccess) err = encode_map(&vm, v, P * bh, seq_k, D, 64, Cfg::ROWS);
  if (err == cudaSuccess) err = units_of<Cfg::ROWS>(seq_k, bh, units);
  if (err == cudaSuccess && units > 0x7FFFFFFF / (D / Cfg::SLICE)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = persistent_grid(units * (D / Cfg::SLICE), grid);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg::BYTES;
  return causal ? launch<bwd_dkv_kernel_sm90_stream<P, true>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, D, scale)
                : launch<bwd_dkv_kernel_sm90_stream<P, false>, FWD_THREADS>(
                      grid, smem, stream, qm, km, vm, dom, lse, delta, dk, dv, bh, seq_q, seq_k, D, scale);
}

}  // namespace

// ------------------------------------------------------------ C interface
// dtype: 1 = bfloat16, 2 = float32 as rt_split4's parts (any other:
// cudaErrorInvalidValue). head_dim: 32, 64, 96, 128, 256 or 512 (bf16) and
// 32, 64, 96, 128 or 256 (parts) for rt_flash_fwd, rt_flash_bwd_dq and
// rt_flash_bwd_dkv; any multiple of 512 for the streamed entry points (the
// wrappers pad any other width to the next of these). Each function returns
// the cudaError_t of its launch (0 on success); the kernel runs on `stream`
// and nothing here synchronises or allocates.

// In each backward function, FN(W) names the Hopper launcher of width W for
// the dtype (P = 1: bf16; P = 2: parts).
#define RT_DISPATCH(CALL, HOPPER)                                                                 \
  if (dtype == 1) {                                                                               \
    CALL(32, (HOPPER<32, 1>)) CALL(64, (HOPPER<64, 1>)) CALL(96, (HOPPER<96, 1>))                 \
    CALL(128, (HOPPER<128, 1>)) CALL(256, (HOPPER<256, 1>)) CALL(512, (HOPPER<512, 1>))           \
  } else if (dtype == 2) {                                                                        \
    CALL(32, (HOPPER<32, 2>)) CALL(64, (HOPPER<64, 2>)) CALL(96, (HOPPER<96, 2>))                 \
    CALL(128, (HOPPER<128, 2>)) CALL(256, (HOPPER<256, 2>))                                       \
  }                                                                                               \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" {

int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                 int seq_q, int seq_k, int head_dim, float scale, int causal, int dtype,
                 void* stream) {
#define RT_FWD(W, FN)                                                                         \
  if (head_dim == W)                                                                          \
    return FN(q, k, v, o, static_cast<float*>(lse), bh, seq_q, seq_k, scale, causal != 0, \
              static_cast<cudaStream_t>(stream));
  if (dtype == 1) {
    RT_FWD(32, fwd_sm90<32>)
    RT_FWD(64, fwd_sm90<64>)
    RT_FWD(96, fwd_sm90<96>)
    RT_FWD(128, fwd_sm90<128>)
    RT_FWD(256, fwd_sm90<256>)
    RT_FWD(512, fwd_sm90<512>)
  } else if (dtype == 2) {
    RT_FWD(32, fwd_sm90_f32<32>)
    RT_FWD(64, fwd_sm90_f32<64>)
    RT_FWD(96, fwd_sm90_f32<96>)
    RT_FWD(128, fwd_sm90_f32<128>)
    RT_FWD(256, fwd_sm90_f32<256>)
  }
#undef RT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// B1 (B2 with lse) with S's contraction streamed (fwd_kernel_sm90_stream):
// dtype 1 (bf16, o bf16) or 2 (rt_split4's parts, o f32) at any head_dim
// that is a multiple of 512 (the wrappers zero-pad to one).
int rt_flash_fwd_stream(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int seq_q,
                        int seq_k, int head_dim, float scale, int causal, int dtype, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd_sm90_stream<1>(q, k, v, o, l, bh, seq_q, seq_k, head_dim, scale, causal != 0, st);
  if (dtype == 2) return fwd_sm90_stream<2>(q, k, v, o, l, bh, seq_q, seq_k, head_dim, scale, causal != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 route's split pass: the f32 operands x0-x3 of n0-n3 elements
// into `parts`, 2 (n0 + n1 + n2 + n3) bf16 (split_kernel). The first
// operand with n = 0 ends the list (the forward splits q, k and v, the
// backward do, or q, k, v and do); each n is a multiple of 4 and every
// pointer is 16-byte aligned.
int rt_split4(const void* x0, const void* x1, const void* x2, const void* x3, void* parts, long long n0,
              long long n1, long long n2, long long n3, void* stream) {
  const long long n[4] = {n0, n1, n2, n3};
  unsigned count = 0;
  long long most = 0;
  while (count < 4 && n[count] > 0) {
    if (n[count] % 4) return static_cast<int>(cudaErrorInvalidValue);
    most = n[count] / 4 > most ? n[count] / 4 : most;
    ++count;
  }
  for (unsigned i = count; i < 4; ++i)
    if (n[i] != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(most / 256 + 1 < 4096 ? most / 256 + 1 : 4096), count);
  split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x0), static_cast<const float4*>(x1), static_cast<const float4*>(x2),
      static_cast<const float4*>(x3), static_cast<uint2*>(parts), static_cast<size_t>(n0 / 4),
      static_cast<size_t>(n1 / 4), static_cast<size_t>(n2 / 4), static_cast<size_t>(n3 / 4));
  return static_cast<int>(cudaGetLastError());
}

int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int bh, int seq_q, int seq_k,
                    int head_dim, float scale, int causal, int dtype, void* stream) {
#define RT_DQ(W, FN)                                                                                 \
  if (head_dim == W)                                                                                 \
    return FN(q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),       \
              static_cast<float*>(dq), bh, seq_q, seq_k, scale, causal != 0, static_cast<cudaStream_t>(stream));
  RT_DISPATCH(RT_DQ, bwd_dq_sm90)
#undef RT_DQ
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bh, int seq_q,
                     int seq_k, int head_dim, float scale, int causal, int dtype, void* stream) {
#define RT_DKV(W, FN)                                                                                \
  if (head_dim == W)                                                                                 \
    return FN(q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),       \
              static_cast<float*>(dk), static_cast<float*>(dv), bh, seq_q, seq_k, scale, causal != 0,  \
              static_cast<cudaStream_t>(stream));
  RT_DISPATCH(RT_DKV, bwd_dkv_sm90)
#undef RT_DKV
}

// B3 and B4 with S's and dP's contraction streamed (bwd_dq_kernel_sm90_stream,
// bwd_dkv_kernel_sm90_stream): dtype 1 (bf16) or 2 (rt_split4's parts) at
// any head_dim that is a multiple of 512 (the wrappers zero-pad to one).
int rt_flash_bwd_dq_stream(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int seq_q, int seq_k, int head_dim, float scale,
                           int causal, int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_dq_sm90_stream<1>(q, k, v, dout, l, d, out, bh, seq_q, seq_k, head_dim, scale, causal != 0, st);
  if (dtype == 2)
    return bwd_dq_sm90_stream<2>(q, k, v, dout, l, d, out, bh, seq_q, seq_k, head_dim, scale, causal != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int rt_flash_bwd_dkv_stream(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh, int seq_q, int seq_k, int head_dim,
                            float scale, int causal, int dtype, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_dkv_sm90_stream<1>(q, k, v, dout, l, d, k_out, v_out, bh, seq_q, seq_k, head_dim, scale,
                                  causal != 0, st);
  if (dtype == 2)
    return bwd_dkv_sm90_stream<2>(q, k, v, dout, l, d, k_out, v_out, bh, seq_q, seq_k, head_dim, scale,
                                  causal != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

#ifdef RT_TIMELINE
// Copies the stamps into dst (host memory, [9][2][64][6] int64) and clears them.
int rt_timeline(void* dst) {
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(dst, timeline, sizeof(timeline));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, timeline);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(timeline));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
