// The x apply on the tensor cores, for Hopper (sm_90a), behind a plain C
// interface: out = M @_x f, or out = s - M @_x f, for M (n_out, n_in)
// float32 and f (n_in, ny, nz) float32, in five forms:
//   DENSE   out = M f, and DENSE + SUB: out = s - M f;
//   FWD     the forward parity split of a transform-folded M:
//           [E; O] = [Me (f1 + f2); Mo (f1 - f2)], f1, f2 the halves of f;
//   INV     the inverse one: [a + b; a - b], a = Me f_e, b = Mo f_o, and
//           INV + SUB.
// FWD and INV take the stacked [Me; Mo] (n_out, n_in / 2).
//
// Replaces four TPU kernels of x3d2_tpu, which compute these functions:
//   - _x_apply_kernel (pallas_poisson.py:954, pl.pallas_call :1346), the
//     dense x stage of a wall-bounded x and of any x with X3D2_BFLY=0
//     (DENSE, DENSE + SUB), launched by ops/operator_apply.py apply_dense
//     for the slab's x_apply and the sharded step's XApplyOp;
//   - _x_parity_fwd_kernel (pallas_poisson.py:997) and
//     _x_parity_inv_kernel (:1025; pl.pallas_call :1310), the one-field
//     parity x stage of a periodic x (FWD; INV, INV + SUB), launched by
//     ops/pressure_slab.py x_apply_parity (x_pfwd, x_pinv, x_pinv[sub]:
//     X3D2_MERGED_X=0, compensated stepping's pressure_grads, every
//     sharded periodic step);
//   - the manual-DMA x apply (make_x_apply_manual, pallas_manual.py:62;
//     its `kernel` :114, pl.pallas_call :200), which is _x_apply_kernel
//     with its own S-slot copy pipeline, in every form, launched by
//     ops/x_apply_manual.py (on no solver path; tools/prof_manual.py).
// All sum bf16 hi/lo splits of their operands in float32 on the MXU
// (split_hi_lo, pallas_kernels.py:60; _mm_left, pallas_poisson.py:54).
// Here the split is TF32's, to float32 accuracy:
//   x = hi + lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi),
//   P = A_lo B_hi + A_hi B_lo + A_hi B_hi   (the small terms first),
// three TF32 tensor-core products into float32 accumulators; the dropped
// lo lo term is below 2^-22 of |A| |B|. The tensor cores do not round
// their float32 sums to nearest, so they sum one k chunk (16 k, six
// products) at a time, and each chunk's P is added to the output's sums
// in registers by FP32 adds (round to nearest): with the tensor cores'
// sums running over all of K, 513 points read 5x plain float32's
// distance to float64.
//
// Bound on an H100: n_in multiply-adds an output (n_in / 2 in the parity
// forms), three times over in TF32: the dense apply at 512^3 is 1.4e11
// operations, 0.83 ms at 3 x the 495 TFLOP/s TF32 rate, against 0.32 ms
// for its two field passes at 3.35 TB/s: bound by operations (2.05 ms at
// the 67 TFLOP/s FP32 rate the SIMT x applies had). The parity forms do
// half the operations: 0.42 ms at 512^3, against 0.32 ms of bytes (0.48
// with the subtraction's third field).
//
// Design. wgmma reads TF32 operands from shared memory K-major only, and
// the field (n_in, ny nz) is contiguous along its columns, so the kernel
// computes the transposed tile: D^T (plane columns x output rows) =
// F^T M^T. F^T is the A operand, read from the staged field tile into
// registers and split there (FWD forms f1 +/- f2 first); M_hi and M_lo
// are the B operands, in shared memory as M lies (row-major (n_out, K) is
// K-major). The operator's split is made once per operator on the host
// (ops/x_apply_manual.py pack), padded to whole tiles and laid out in
// device memory as the shared-memory image of each (part, row tile, k
// chunk) block: BN rows of KC = 16 tf32 (64 bytes, 64-byte swizzled), hi
// then lo, so one bulk copy brings a block. The field comes by TMA
// through a tensor map (encoded at each launch): boxes of 32 plane
// columns by KC rows, 128-byte swizzled, zero-filled past the field's
// extents (one copy a field row cost the issuing warp as much as the
// tensor cores' work).
// A persistent grid, one block an SM, walks work items: a column tile of
// BM = 128 plane columns and a row tile of BN output rows (DENSE 128; FWD
// and INV 64 rows of each half, both halves an item: FWD forms s = f1 + f2
// and d = f1 - f2 once from one read of f1 and f2 and sums E = Me s and O
// = Mo d in two sets of sums, INV sums a and b apart), block b taking
// items b, b + grid, ... An item's contraction runs over k chunks of KC in
// one fixed order whatever the extents (INV: the a source's chunks, then
// the b source's): no split-K and no atomics, so two launches give the
// same bits and a column's result does not depend on the other columns.
// One producer warp keeps the chunks in flight through an S-stage ring of
// shared memory (full mbarriers completed by the copies' bytes, empty
// ones by the consumer warps; a stage holds the chunk's operator blocks
// and field blocks: DENSE 24 KB, FWD 32 KB (both halves'), INV 16 KB, so
// FWD takes S = 2 to 7 and the others 2 to 8); its warpgroup hands its
// registers to the two consumer warpgroups (setmaxnreg). A consumer
// warpgroup takes 64 plane columns (a_columns in the wrapper: the column
// order that makes its fragment loads conflict-free on the swizzled boxes)
// and, per chunk,
// issues 3 wgmma m64nNk8 for each of its two k steps of 8 and each set of
// sums, loads and splits the next chunk's fragments while they run, then
// adds the chunk's sums to its registers and frees the stage. Rows past
// the operator's (n_out, or the half) are zero in the packed operator and
// masked at the store; k past K is zero in the packed operator and masked
// in the A fragments; columns past ny nz are zero-filled and not stored.
// The epilogue stores each thread's sums from its registers (SUB: all of
// the item's s loaded first), 16-byte runs of a row (no staging: the
// shared memory is the ring's).
// Host side: each instance's shared-memory attribute is set to the card's
// most once per device (an atomic flag; any thread may launch); the
// launch's own size is given at each launch.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NCONS = 256;           // consumer threads: two warpgroups
constexpr int NTHR = NCONS + 128;    // and the producer warpgroup
constexpr int NCW = NCONS / 32;      // consumer warps (empty arrivals)
constexpr int BM = 128;              // plane columns an item
constexpr int KC = 16;               // k a chunk: one 64-byte row of tf32
constexpr int FBOX = 32;             // plane columns a field box (128 B)
constexpr int FBOX_BYTES = FBOX * KC * 4;
constexpr int MAX_S = 8;
// the fixed dynamic shared memory: a full and an empty barrier a stage,
// the 1024-byte alignment
constexpr int SMEM_FIXED = 8 * 2 * MAX_S + 1024;
constexpr int SMEM_MAX = 232448;     // a block's shared memory on an H100
constexpr int MAX_DEV = 16;
// registers a thread after the hand-over (setmaxnreg): the block starts
// with three warpgroups of 168; the producer warpgroup (one warp copies,
// three leave) keeps 40 and the two consumer warpgroups take 232
// (128 x 40 + 256 x 232 <= 65536)
constexpr int PROD_REGS = 40;
constexpr int CONS_REGS = 232;

enum { DENSE = 0, FWD = 1, INV = 2 };

// output rows of a part an item (the wgmma N)
__host__ __device__ constexpr int tile_rows(int form) {
  return form == DENSE ? 128 : 64;
}
// bytes of an operator block (hi and lo)
__host__ __device__ constexpr int op_bytes(int form) {
  return 2 * tile_rows(form) * KC * 4;
}
// operator blocks and field blocks a stage holds: FWD both halves' (Me
// and Mo; f1 and f2), the others one
__host__ __device__ constexpr int stage_parts(int form) {
  return form == FWD ? 2 : 1;
}
// bytes of a stage: its operator blocks, then its field blocks, each BM /
// FBOX boxes of KC rows of 128 bytes; every block starts on a 1024-byte
// swizzle atom
__host__ __device__ constexpr int stage_bytes(int form) {
  return stage_parts(form) * (op_bytes(form) + (BM / FBOX) * FBOX_BYTES);
}

struct TcArgs {
  const float* op;   // packed: (parts, rtiles, ktiles, 2, BN * KC)
  const float* f;    // (n_in, ncols): DENSE n_in = K, FWD and INV 2 K
  const float* s;    // (n_out, ncols) or null
  float* out;        // (n_out, ncols)
  int rows;          // output rows of a part: DENSE n_out, else n_out / 2
  int K;
  int rtiles;        // row tiles of a part
  int ktiles;        // k chunks (the packed operator's K padded to KC)
  long long ncols;
  int nitems;
  int slots;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a TMA load of one field box (FBOX columns from c0, KC rows from row0;
// past the field's extents zero-filled) into shared memory, completing on
// mbarrier `bar`
__device__ __forceinline__ void box_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(row0), "r"(bar)
      : "memory");
}

// the operand of a k step's wgmma: N rows of the operator's block from
// shared address `addr`, K-major with the 64-byte swizzle (rows of 64
// bytes, 8-row atoms 512 bytes apart; the leading offset is not read for
// a swizzled K-major operand); the next k step of 8 tf32 starts 32 bytes
// on
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// x = hi + lo, both tf32 (cvt.rna, ties away from zero; the low 13 bits
// cleared)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xFFFFE000u;
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

// the accumulators are read and written only after the wgmma that writes
// them has been waited for, and an A fragment stays in its registers until
// the wgmma that reads it is done
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_reg(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// D (64 x 64, 32 floats a thread) = D acc + A (64 x 8, tf32 from
// registers)
// . B (8 x 64, tf32 in shared memory, K-major, 64-byte swizzle)
__device__ __forceinline__ void mma_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// D (64 x 128, 64 floats a thread) = D acc + A (64 x 8, tf32 from
// registers)
// . B (8 x 128, tf32 in shared memory, K-major, 64-byte swizzle)
__device__ __forceinline__ void mma_n128(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// the three products of one k step into d: A_lo B_hi, A_hi B_lo, A_hi
// B_hi; acc = 0: the first replaces d
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint64_t dhi,
                                     uint64_t dlo, int acc) {
  if constexpr (N == 128) {
    mma_n128(d, alo, dhi, acc);
    mma_n128(d, ahi, dlo, 1);
    mma_n128(d, ahi, dhi, 1);
  } else {
    mma_n64(d, alo, dhi, acc);
    mma_n64(d, ahi, dlo, 1);
    mma_n64(d, ahi, dhi, 1);
  }
}

template <int FORM, bool SUB>
__global__ void __launch_bounds__(NTHR, 1)
x_apply_tc_kernel(const __grid_constant__ TcArgs a,
                  const __grid_constant__ CUtensorMap fmap) {
  constexpr int BN = tile_rows(FORM);
  constexpr int NV = BN / 2;                    // sums a set a thread
  constexpr int NP = stage_parts(FORM);         // operator and field blocks
  constexpr int NSRC = FORM == INV ? 2 : 1;     // sources an item
  constexpr int OPB = op_bytes(FORM);
  constexpr int NBOX = BM / FBOX;               // field boxes a block
  constexpr int FB = NBOX * FBOX_BYTES;         // bytes of a field block
  constexpr int ST = stage_bytes(FORM);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  // the ring, then the barriers
  const unsigned char* ring_p = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const int S = a.slots;
  const uint32_t bar_full = ring + S * ST;
  const uint32_t bar_empty = bar_full + 8 * MAX_S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = a.ktiles;
  const int my = a.nitems > (int)blockIdx.x
                     ? (a.nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                     : 0;
  // item j of the block: its column tile's first column, its row tile
  struct Item {
    long long c0;
    int rt;
  };
  auto item_of = [&](int j) {
    const int it = (int)blockIdx.x + j * (int)gridDim.x;
    Item m;
    m.c0 = (long long)(it / a.rtiles) * BM;
    m.rt = it % a.rtiles;
    return m;
  };
  // the operator block (part, row tile, k chunk) of the packed operator
  auto op_block = [&](int part, int rt, int kc) {
    return (part * a.rtiles + rt) * nk + kc;
  };

  if (threadIdx.x >= NCONS) {
    // ---- the producer warpgroup gives its registers to the consumers;
    // its first warp walks the chunks of the block's items, in order, each
    // into the next stage once the consumers have freed it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS));
    if (threadIdx.x >= NCONS + 32) return;
    const int lane = threadIdx.x & 31;
    int st = 0;
    uint32_t ph = 0;
    for (int j = 0; j < my; ++j) {
      const Item m = item_of(j);
      for (int src = 0; src < NSRC; ++src) {
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(bar_empty + 8 * st, ph ^ 1);
          const uint32_t full = bar_full + 8 * st;
          const uint32_t dst = ring + st * ST;
          if (lane == 0) {
            mbar_expect_tx(full, NP * (OPB + FB));
            // the operator's parts: DENSE's one, FWD's Me and Mo, INV's
            // source's (Me for a, Mo for b)
            for (int o = 0; o < NP; ++o)
              bulk_load(dst + o * OPB,
                        a.op + (long long)op_block(FORM == INV ? src : o,
                                                   m.rt, kc) * (OPB / 4),
                        OPB, full);
          }
          __syncwarp();
          if (lane < NP * NBOX) {
            // the field's rows k0 .. k0 + KC - 1 of f (DENSE), f1 and f2
            // (FWD), f_e or f_o (INV); rows past K are read (f2's, or
            // zeros past the field) and masked in the A fragments
            const int b = lane / NBOX, q = lane % NBOX;
            box_load(dst + NP * OPB + (b * NBOX + q) * FBOX_BYTES, &fmap,
                     (int)m.c0 + q * FBOX,
                     kc * KC + (b == 1 || src == 1 ? a.K : 0), full);
          }
          if (++st == S) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup g takes the field boxes 2 g and 2 g + 1
  // of the item (64 plane columns), warp w of it 16 columns of box 2 g + (w
  // >> 1): its A rows gid and gid + 8 (wgmma's) are the columns 4 a[h] +
  // (gid & 3) of the box, a[h] = 2 (w & 1) + h + 4 (gid >> 2), h = 0, 1,
  // so that the 32 lanes of a fragment load read 32 banks of the 128-byte
  // swizzled rows (ops/x_apply_manual.py a_columns); its k columns tig and
  // tig + 4 of each k step
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = t >> 7, w = (t >> 5) & 3;
  const int box = 2 * wg + (w >> 1);
  const int ach[2] = {2 * (w & 1) + 4 * (gid >> 2),
                      2 * (w & 1) + 1 + 4 * (gid >> 2)};
  const int nkc = NSRC * nk;                  // chunks an item
  float acc[NV];
  float acc2[FORM == DENSE ? 1 : NV];         // FWD: O's sums; INV: b's
  float part[NV];                             // a chunk's tensor-core sum
  float part2[FORM == FWD ? NV : 1];          // FWD: O's
  // the A fragments of a chunk's two k steps, split: a0 (row gid, k), a1
  // (gid + 8, k), a2 (gid, k + 4), a3 (gid + 8, k + 4), k = 8 step + tig;
  // the chunk in the tensor cores' hands (ahi, alo; FWD: of s, and bhi,
  // blo of d) and the next (nhi, nlo; mhi, mlo)
  uint32_t ahi[2][4], alo[2][4], nhi[2][4], nlo[2][4];
  uint32_t bhi[2][4], blo[2][4], mhi[2][4], mlo[2][4];
  auto load_a = [&](int c, int stage, uint32_t ph_, uint32_t (&hi)[2][4],
                    uint32_t (&lo)[2][4], uint32_t (&hi2)[2][4],
                    uint32_t (&lo2)[2][4]) {
    mbar_wait(bar_full + 8 * stage, ph_);
    // the box: KC rows of 128 bytes, the 16-byte chunk a of row k at a ^
    // (k & 7) (TMA's 128-byte swizzle)
    const unsigned char* F =
        ring_p + stage * ST + NP * OPB + box * FBOX_BYTES + (gid & 3) * 4;
    const int k0 = (c % nk) * KC;
#pragma unroll
    for (int step = 0; step < 2; ++step)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = step * 8 + tig + (i >> 1) * 4;
        const int off = kk * 128 + ((ach[i & 1] ^ (kk & 7)) << 4);
        const bool ok = k0 + kk < a.K;
        const float x = *reinterpret_cast<const float*>(F + off);
        if constexpr (FORM == FWD) {
          const float x2 = *reinterpret_cast<const float*>(F + FB + off);
          split_tf32(ok ? x + x2 : 0.f, hi[step][i], lo[step][i]);
          split_tf32(ok ? x - x2 : 0.f, hi2[step][i], lo2[step][i]);
        } else {
          split_tf32(ok ? x : 0.f, hi[step][i], lo[step][i]);
        }
      }
  };
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < my; ++j) {
    const Item m = item_of(j);
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (FORM == DENSE ? 1 : NV); ++i) acc2[i] = 0.f;
    load_a(0, st, ph, ahi, alo, bhi, blo);
    for (int c = 0; c < nkc; ++c) {
      // the chunk's operator blocks in the stage (the source's part; FWD's
      // Mo second); k step `step` starts 32 bytes, 2 descriptor units, on
      const uint32_t ob = ring + st * ST, ob2 = ob + OPB;
      const uint64_t dhi = b_desc(ob), dlo = b_desc(ob + OPB / 2);
      wgmma_fence();
#pragma unroll
      for (int step = 0; step < 2; ++step)
        mma3<BN>(part, ahi[step], alo[step], dhi + 2 * step,
                 dlo + 2 * step, step);
      if constexpr (FORM == FWD) {
        const uint64_t ehi = b_desc(ob2), elo = b_desc(ob2 + OPB / 2);
#pragma unroll
        for (int step = 0; step < 2; ++step)
          mma3<BN>(part2, bhi[step], blo[step], ehi + 2 * step,
                   elo + 2 * step, step);
      }
      wgmma_commit();
      // the next chunk's fragments while the tensor cores work
      const int st1 = st + 1 == S ? 0 : st + 1;
      const uint32_t ph1 = st1 == 0 ? ph ^ 1 : ph;
      if (c + 1 < nkc) load_a(c + 1, st1, ph1, nhi, nlo, mhi, mlo);
      wgmma_wait();
      fence_acc(part);
      fence_reg(ahi);
      fence_reg(alo);
      if constexpr (FORM == FWD) {
        fence_acc(part2);
        fence_reg(bhi);
        fence_reg(blo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      st = st1;
      ph = ph1;
#pragma unroll
      for (int step = 0; step < 2; ++step)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[step][i] = nhi[step][i];
          alo[step][i] = nlo[step][i];
          if constexpr (FORM == FWD) {
            bhi[step][i] = mhi[step][i];
            blo[step][i] = mlo[step][i];
          }
        }
      // added to the item's sums in FP32 (round to nearest): the tensor
      // cores' own sum spans one chunk
      if constexpr (FORM == FWD) {
#pragma unroll
        for (int i = 0; i < NV; ++i) acc2[i] += part2[i];
      }
      if constexpr (FORM == INV) {
        if (c >= nk) {
#pragma unroll
          for (int i = 0; i < NV; ++i) acc2[i] += part[i];
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += part[i];
    }
    // the item's outputs: d[4 j + 2 c + q] is (A row gid + 8 c, that is
    // column 4 ach[c] + (gid & 3) of the box, output row 8 j + 2 tig + q
    // of the tile); group g: the output half (FWD E, O; INV a + b,
    // a - b); SUB reads all of its s first, then stores
    constexpr int G = FORM == DENSE ? 1 : 2;
    const int nrows = a.rows - m.rt * BN < BN ? a.rows - m.rt * BN : BN;
    const long long col[2] = {m.c0 + box * FBOX + 4 * ach[0] + (gid & 3),
                              m.c0 + box * FBOX + 4 * ach[1] + (gid & 3)};
    const bool okc[2] = {col[0] < a.ncols, col[1] < a.ncols};
    auto row_of = [&](int g, int n) {
      return (long long)g * a.rows + m.rt * BN + n;
    };
    float sv[SUB ? G * NV : 1];
    if constexpr (SUB) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int n = (i >> 2) * 8 + 2 * tig + (i & 1);
          const int c = (i >> 1) & 1;
          sv[g * NV + i] =
              n < nrows && okc[c]
                  ? __ldg(a.s + row_of(g, n) * a.ncols + col[c]) : 0.f;
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int n = (i >> 2) * 8 + 2 * tig + (i & 1);
        const int c = (i >> 1) & 1;
        if (n >= nrows || !okc[c]) continue;
        float v = acc[i];
        if constexpr (FORM == FWD) v = g == 0 ? acc[i] : acc2[i];
        if constexpr (FORM == INV) v = g == 0 ? v + acc2[i] : v - acc2[i];
        if constexpr (SUB) v = sv[g * NV + i] - v;
        a.out[row_of(g, n) * a.ncols + col[c]] = v;
      }
  }
}

// One launch of an instance at `bytes` of dynamic shared memory; the
// instance's attribute is raised to SMEM_MAX once per device
template <int FORM, bool SUB>
cudaError_t launch(const TcArgs& a, const CUtensorMap& fmap, int grid,
                   int bytes, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEV || !ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(x_apply_tc_kernel<FORM, SUB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEV) ready[dev].store(true, std::memory_order_release);
  }
  x_apply_tc_kernel<FORM, SUB><<<grid, NTHR, bytes, stream>>>(a, fmap);
  return cudaGetLastError();
}

// the field's tensor map: (frows, ncols) float32, boxes of KC rows of FBOX
// columns, 128-byte swizzled, zeros past the extents (the driver's encoder,
// found through the runtime: no link to the driver library)
cudaError_t field_map(CUtensorMap* map, const void* f, long long frows,
                      long long ncols) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)ncols, (cuuint64_t)frows};
  const cuuint64_t strides[1] = {(cuuint64_t)ncols * 4};
  const cuuint32_t boxd[2] = {FBOX, KC};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(f), dims,
      strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Compile-time geometry, for the wrapper's packing and checks: plane
// columns an item, k a chunk, the staged field row, the most stages,
// threads a block, the fixed dynamic shared memory, a block's most, then
// output rows an item, bytes of an operator block and bytes of a stage for
// DENSE, FWD, INV.
int x_apply_tc_geometry(int* g) {
  g[0] = BM;
  g[1] = KC;
  g[2] = FBOX;
  g[3] = MAX_S;
  g[4] = NTHR;
  g[5] = SMEM_FIXED;
  g[6] = SMEM_MAX;
  for (int form = DENSE; form <= INV; ++form) {
    g[7 + form] = tile_rows(form);
    g[10 + form] = op_bytes(form);
    g[13 + form] = stage_bytes(form);
  }
  return 0;
}

// One launch. form: 0 dense, 1 parity forward, 2 parity inverse; op: the
// packed split operator (ops/x_apply_manual.py pack) of `rows` output rows
// a part and contraction K; f, s (null without the subtraction), out as
// TcArgs; ncols = ny * nz, a multiple of 4; slots 2 .. MAX_S where the ring
// fits (FWD 2 .. 7); grid: blocks (the SM count). Returns the cudaError_t
// of the launch (0 on success).
int x_apply_tc_launch(int form, const void* op, const void* f,
                      const void* s, void* out, int rows, int K,
                      long long ncols, int slots, int grid, void* stream) {
  if (form < DENSE || form > INV || (form == FWD && s != nullptr)
      || rows < 1 || K < 1 || ncols < 4 || ncols % 4 || slots < 2
      || slots > MAX_S || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int bn = tile_rows(form);
  TcArgs a = {};
  a.op = static_cast<const float*>(op);
  a.f = static_cast<const float*>(f);
  a.s = static_cast<const float*>(s);
  a.out = static_cast<float*>(out);
  a.rows = rows;
  a.K = K;
  a.rtiles = (rows + bn - 1) / bn;
  a.ktiles = (K + KC - 1) / KC;
  a.ncols = ncols;
  const long long items = (ncols + BM - 1) / BM * a.rtiles;
  const int bytes = slots * stage_bytes(form) + SMEM_FIXED;
  if (items > 0x7FFFFFFFLL || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  a.nitems = (int)items;
  a.slots = slots;
  if (grid > a.nitems) grid = a.nitems;
  CUtensorMap fmap;
  const cudaError_t e =
      field_map(&fmap, f, (long long)K * (form == DENSE ? 1 : 2), ncols);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form * 2 + (s != nullptr ? 1 : 0)) {
    case DENSE * 2: return (int)launch<DENSE, false>(a, fmap, grid, bytes, st);
    case DENSE * 2 + 1:
      return (int)launch<DENSE, true>(a, fmap, grid, bytes, st);
    case FWD * 2: return (int)launch<FWD, false>(a, fmap, grid, bytes, st);
    case INV * 2: return (int)launch<INV, false>(a, fmap, grid, bytes, st);
    case INV * 2 + 1: return (int)launch<INV, true>(a, fmap, grid, bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* x_apply_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
