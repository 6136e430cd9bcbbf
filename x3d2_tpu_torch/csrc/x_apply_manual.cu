// Operator applies on the tensor cores, for Hopper (sm_90a), behind a plain
// C interface: out = M @_a f, or out = s - M @_a f, for M (n_out, n_in)
// float32 applied along one axis a of f float32, in five forms:
//   DENSE   out = M f, and DENSE + SUB: out = s - M f;
//   FWD     the forward parity split of a transform-folded M:
//           [E; O] = [Me (f1 + f2); Mo (f1 - f2)], f1, f2 the halves of f;
//   INV     the inverse one: [a + b; a - b], a = Me f_e, b = Mo f_o, and
//           INV + SUB;
//   FWD + SOLVE (the x layout): the spectral solve in FWD's epilogue,
//           q[r, c] = F[r, c] * (-1 / (k2x[r] A[c] + tx2[r] B[c])), and 0
//           where |k2x[r] A[c] + tx2[r] B[c]| < 1e-16, from four float32
//           tables: A, B per plane column (the (y, z) modes in q's order),
//           k2x, tx2 per output row (the x modes in block-parity order).
// FWD and INV take the stacked [Me; Mo] (n_out, n_in / 2). The axis is
// one of three layouts of an (nx, ny, nz) field:
//   x       f (n_in, ny nz): one plane, its columns contiguous;
//   y       f (nx, n_in, nz): nx planes of nz columns, batched;
//   z       f (nx ny lines, n_in), the contraction along the contiguous
//           axis (LINES, the transposed form): FWD and INV.
// A launch takes up to three jobs of one form and one operator size: a
// job sums the applies of one or two sources (M1 f1 + M2 f2) into its
// output, or subtracts the sum from its s.
//
// Replaces seven TPU kernels of x3d2_tpu, which compute these functions:
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
//   - _pipe_a_kernel (pallas_poisson.py:1378, pl.pallas_call :1619) and
//     _pipe_c_kernel (:1455, pl.pallas_call :1703), the pipeline's stages
//     A and C, two launches each (ops/pressure_pipe.py): A a z FWD launch
//     (Iz u, Iz v, Sz w) and a y FWD launch (a = TyI z1, e = TyS z2 + TyI
//     z3, one job of two sources); C a z INV launch (Gzi X, Gzs Y, Gzi Y)
//     and a y INV + SUB launch (u - GiT px, v - GsT pzy, w - GiT dzy). The
//     banded y applies are folded into the y transforms: the y operators
//     of every pipeline grid are circulant, so Ty C and C Tyi are parity
//     operators of the transforms' size (pressure_pipe.fold_y);
//   - _pipe_b_kernel (pallas_poisson.py:1405, pl.pallas_call :1669), the
//     pipeline's stage B, two launches (ops/pressure_pipe.py pipe_b_x,
//     pipe_b_inv): an x FWD + SOLVE launch of one two-source job, q =
//     solve(Sx a + Ix e), then an x INV launch of two jobs, X = Gxs q and
//     Y = Gxi q. The TPU kernel keeps a (y, z) tile's whole x extent in
//     VMEM and q never reaches HBM; here q goes through device memory (an
//     item's 128 columns of all nx rows of q are 256 KB at nx = 512, past
//     a block's 227 KB), two fields more than the function's four;
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
// distance to float64. INV sums each k step of 8 (three products) apart
// and adds the two in FP32: on the pipeline's q, whose few low x modes
// carry max |X| and max |Y|, six truncating products a chunk put stage
// B's INV launch past the 4e-7 of float64 the kernel is held to
// (chip_smoke.py tc_launches).
//
// Bound on an H100: n_in multiply-adds an output (n_in / 2 in the parity
// forms), three times over in TF32: the dense apply at 512^3 is 1.4e11
// operations, 0.83 ms at 3 x the 495 TFLOP/s TF32 rate, against 0.32 ms
// for its two field passes at 3.35 TB/s: bound by operations (2.05 ms at
// the 67 TFLOP/s FP32 rate the SIMT x applies had). The parity forms do
// half the operations: 0.42 ms a field at 512^3, against 0.32 ms of
// bytes (0.48 with the subtraction's third field).
//
// Design. wgmma reads TF32 operands from shared memory K-major only. In the
// x and y layouts the field is contiguous along its columns, so the kernel
// computes the transposed tile: D^T (plane columns x output rows) = F^T
// M^T; in the z layout it computes D (lines x output rows) = F M^T, F
// K-major as it lies. Either way the field is the A operand, read from the
// staged field tile into registers and split there (FWD forms f1 +/- f2
// first), and M_hi and M_lo are the B operands, in shared memory as M lies
// (row-major (n_out, K) is K-major). The operator's split is made once per
// operator on the host (ops/x_apply_manual.py pack), padded to whole tiles
// and laid out in device memory as the shared-memory image of each (part,
// row tile, k chunk) block: BN rows of KC = 16 tf32 (64 bytes, 64-byte
// swizzled), hi then lo, so one bulk copy brings a block. The field comes
// by TMA through a 3-D tensor map a source (encoded at each launch), zero
// past the field's extents (one copy a field row cost the issuing warp as
// much as the tensor cores' work): x and y boxes of 32 plane columns by KC
// rows of one plane, 128-byte swizzled; z boxes of 32 lines by KC (64
// bytes), 64-byte swizzled.
// A persistent grid, one block an SM, walks work items: a job, a plane, a
// column tile of BM = 128 plane columns (z: lines) and a row tile of BN
// output rows (DENSE 128; FWD and INV 64 rows of each half, both halves an
// item: FWD forms s = f1 + f2 and d = f1 - f2 once from one read of f1 and
// f2 and sums E = Me s and O = Mo d in two sets of sums, INV sums a and b
// apart), block b taking items b, b + grid, ... An item's contraction runs
// over k chunks of KC in one fixed order whatever the extents (a source's
// chunks, then the next source's; INV: a source's a chunks, then its b
// chunks): no split-K and no atomics, so two launches give the same bits
// and a column's result does not depend on the other columns.
// One producer warp keeps the chunks in flight through an S-stage ring of
// shared memory (full mbarriers completed by the copies' bytes, empty
// ones by the consumer warps; a stage holds the chunk's operator blocks
// and field blocks: DENSE 24 KB, FWD 32 KB (both halves'), INV 16 KB, so
// FWD takes S = 2 to 7 and the others 2 to 8); its warpgroup hands its
// registers to the two consumer warpgroups (setmaxnreg). A consumer
// warpgroup takes 64 plane columns or lines (a_columns in the wrapper: in
// the x and y layouts the column order that makes its fragment loads
// conflict-free on the swizzled boxes; in the z layout the lines in order)
// and, per chunk,
// issues 3 wgmma m64nNk8 for each of its two k steps of 8 and each set of
// sums (INV: each k step into a set of its own), loads and splits the
// next chunk's fragments while they run, then adds the chunk's sums to
// its registers and frees the stage. Rows past
// the operator's (n_out, or the half) are zero in the packed operator and
// masked at the store; k past K is zero in the packed operator and masked
// in the A fragments; columns past the plane's and lines past the field's
// are zero-filled and not stored.
// The epilogue stores each thread's sums from its registers (SUB: the
// item's s loaded first, DENSE's in two halves; SOLVE: each sum times its
// mode's -1 / waves, the column tables read once an item, the row tables
// once a row; no staging: the shared memory is the ring's): x and y
// 16-byte runs of an output row, z 32-byte
// runs of an output line (pairs of neighbouring rows, 8 bytes a thread),
// which measured no slower a field than the x and y forms' (PERF.md), so
// the z form's stores are not staged.
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
constexpr int BM = 128;              // plane columns (z: lines) an item
constexpr int KC = 16;               // k a chunk: one 64-byte row of tf32
constexpr int FBOX = 32;             // plane columns (z: lines) a box
constexpr int FBOX_BYTES = FBOX * KC * 4;
constexpr int MAX_S = 8;
constexpr int MAX_JOBS = 3;          // jobs a launch
constexpr int MAX_SRC = 2;           // sources a job
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
// the epilogues: store the sums, subtract them from s (DENSE and INV in
// the x and y layouts), or the solve (FWD in the x layout)
enum { STORE = 0, SUB = 1, SOLVE = 2 };

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
// FBOX boxes of FBOX_BYTES; every block starts on a 1024-byte swizzle atom
__host__ __device__ constexpr int stage_bytes(int form) {
  return stage_parts(form) * (op_bytes(form) + (BM / FBOX) * FBOX_BYTES);
}

struct TcArgs {
  // per job and source: the packed operator (parts, rtiles, ktiles, 2, BN
  // * KC); per job: s (the output's shape) or null, the output
  const float* op[MAX_JOBS][MAX_SRC];
  const float* s[MAX_JOBS];
  float* out[MAX_JOBS];
  int nsrc[MAX_JOBS];
  // SOLVE: A, B (ncols each), k2x, tx2 (n_out each)
  const float* tab[4];
  int rows;          // output rows of a part: DENSE n_out, else n_out / 2
  int n_out;
  int K;
  int rtiles;        // row tiles of a part
  int ktiles;        // k chunks (the packed operator's K padded to KC)
  int ctiles;        // column tiles of BM a plane (z: line tiles)
  long long ncols;   // columns of a plane (z: lines)
  int items_job;     // items a job: planes x ctiles x rtiles
  int nitems;
  int slots;
};

// the field's tensor map of each job and source
struct TcMaps {
  CUtensorMap m[MAX_JOBS][MAX_SRC];
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

// a TMA load of one field box at coordinates (c0, c1, c2) of its map (x
// and y: column, row, plane; z: k, line, 0; past the field's extents
// zero-filled) into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void box_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
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

template <int FORM, int EPI, bool LINES>
__global__ void __launch_bounds__(NTHR, 1)
x_apply_tc_kernel(const __grid_constant__ TcArgs a,
                  const __grid_constant__ TcMaps maps) {
  constexpr int BN = tile_rows(FORM);
  constexpr int NV = BN / 2;                    // sums a set a thread
  constexpr int NP = stage_parts(FORM);         // operator and field blocks
  constexpr int NH = FORM == INV ? 2 : 1;       // a source's halves in turn
  constexpr int OPB = op_bytes(FORM);
  constexpr int NBOX = BM / FBOX;               // field boxes a block
  constexpr int FB = NBOX * FBOX_BYTES;         // bytes of a field block
  constexpr int ST = stage_bytes(FORM);
  static_assert(EPI != SOLVE || (FORM == FWD && !LINES),
                "the solve follows the FWD form in the x layout");
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
  // item j of the block: its job, plane, column tile's first column (z:
  // line) and row tile
  struct Item {
    long long c0;
    int rt, plane, job;
  };
  auto job_of = [&](int j) {
    return ((int)blockIdx.x + j * (int)gridDim.x) / a.items_job;
  };
  auto item_of = [&](int j) {
    const int it = (int)blockIdx.x + j * (int)gridDim.x;
    Item m;
    m.job = it / a.items_job;
    int r = it - m.job * a.items_job;
    m.rt = r % a.rtiles;
    r /= a.rtiles;
    m.c0 = (long long)(r % a.ctiles) * BM;
    m.plane = r / a.ctiles;
    return m;
  };
  // the operator block (part, row tile, k chunk) of a packed operator
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
      // a source's chunks (INV: its a chunks, then its b chunks), then the
      // next source's: runs of nk chunks
      for (int run = 0; run < a.nsrc[m.job] * NH; ++run) {
        const int src = run / NH, h = run % NH;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(bar_empty + 8 * st, ph ^ 1);
          const uint32_t full = bar_full + 8 * st;
          const uint32_t dst = ring + st * ST;
          if (lane == 0) {
            mbar_expect_tx(full, NP * (OPB + FB));
            // the source's operator parts: DENSE's one, FWD's Me and Mo,
            // INV's half's (Me for a, Mo for b)
            for (int o = 0; o < NP; ++o)
              bulk_load(dst + o * OPB,
                        a.op[m.job][src]
                            + (long long)op_block(FORM == INV ? h : o, m.rt,
                                                  kc) * (OPB / 4),
                        OPB, full);
          }
          __syncwarp();
          if (lane < NP * NBOX) {
            // the field's rows (z: k) k0 .. k0 + KC - 1 of f (DENSE), f1
            // and f2 (FWD), f_e or f_o (INV); rows past K are read (f2's,
            // or zeros past the field) and masked in the A fragments
            const int b = lane / NBOX, q = lane % NBOX;
            const int k = kc * KC + (b == 1 || h == 1 ? a.K : 0);
            const uint32_t box =
                dst + NP * OPB + (b * NBOX + q) * FBOX_BYTES;
            const CUtensorMap* map = &maps.m[m.job][src];
            if constexpr (LINES)
              box_load(box, map, k, (int)m.c0 + q * FBOX, 0, full);
            else
              box_load(box, map, (int)m.c0 + q * FBOX, k, m.plane, full);
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
  // of the item (64 plane columns or lines), warp w of it 16 of box 2 g +
  // (w >> 1); its k columns tig and tig + 4 of each k step. x and y: its A
  // rows gid and gid + 8 (wgmma's) are the columns 4 a[h] + (gid & 3) of
  // the box, a[h] = 2 (w & 1) + h + 4 (gid >> 2), h = 0, 1, so that the 32
  // lanes of a fragment load read 32 banks of the 128-byte swizzled rows
  // (ops/x_apply_manual.py a_columns). z: its A rows are the box's lines
  // 16 (w & 1) + gid + 8 h, whose 64-byte swizzled rows give the 8 lines
  // of a fragment load 8 distinct 16-byte bank groups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = t >> 7, w = (t >> 5) & 3;
  const int box = 2 * wg + (w >> 1);
  const int ach[2] = {LINES ? 16 * (w & 1) + gid : 2 * (w & 1) + 4 * (gid >> 2),
                      LINES ? 16 * (w & 1) + gid + 8
                            : 2 * (w & 1) + 1 + 4 * (gid >> 2)};
  float acc[NV];
  float acc2[FORM == DENSE ? 1 : NV];         // FWD: O's sums; INV: b's
  float part[NV];                             // a chunk's tensor-core sum
  // FWD: O's; INV: the chunk's second k step's, so that the tensor cores'
  // truncating sums take one k step of 8
  float part2[FORM == DENSE ? 1 : NV];
  // the A fragments of a chunk's two k steps, split: a0 (row gid, k), a1
  // (gid + 8, k), a2 (gid, k + 4), a3 (gid + 8, k + 4), k = 8 step + tig;
  // the chunk in the tensor cores' hands (ahi, alo; FWD: of s, and bhi,
  // blo of d) and the next (nhi, nlo; mhi, mlo)
  uint32_t ahi[2][4], alo[2][4], nhi[2][4], nlo[2][4];
  uint32_t bhi[2][4], blo[2][4], mhi[2][4], mlo[2][4];
  auto load_a = [&](int kc, int stage, uint32_t ph_, uint32_t (&hi)[2][4],
                    uint32_t (&lo)[2][4], uint32_t (&hi2)[2][4],
                    uint32_t (&lo2)[2][4]) {
    mbar_wait(bar_full + 8 * stage, ph_);
    // x and y: the box holds KC rows of 128 bytes, the 16-byte chunk a of
    // row k at a ^ (k & 7) (TMA's 128-byte swizzle); z: FBOX lines of 64
    // bytes, the 16-byte chunk a of line l at a ^ ((l >> 1) & 3) (its
    // 64-byte swizzle)
    const unsigned char* F = ring_p + stage * ST + NP * OPB + box * FBOX_BYTES;
    const int k0 = kc * KC;
#pragma unroll
    for (int step = 0; step < 2; ++step)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = step * 8 + tig + (i >> 1) * 4;
        const int r = ach[i & 1];
        const int off =
            LINES ? r * 64 + (((kk >> 2) ^ ((r >> 1) & 3)) << 4) + tig * 4
                  : kk * 128 + ((r ^ (kk & 7)) << 4) + (gid & 3) * 4;
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
    // the chunks only: the item's place is computed again for its
    // epilogue, so that it holds no registers through the chunks
    const int nkc = a.nsrc[job_of(j)] * NH * nk;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (FORM == DENSE ? 1 : NV); ++i) acc2[i] = 0.f;
    // the chunk's k chunk and half (INV: 0 its source's a, 1 its b),
    // counted along, not divided out
    int kc = 0, hb = 0;
    load_a(0, st, ph, ahi, alo, bhi, blo);
    for (int c = 0; c < nkc; ++c) {
      // the chunk's operator blocks in the stage (the source's part; FWD's
      // Mo second); k step `step` starts 32 bytes, 2 descriptor units, on
      const uint32_t ob = ring + st * ST, ob2 = ob + OPB;
      const uint64_t dhi = b_desc(ob), dlo = b_desc(ob + OPB / 2);
      wgmma_fence();
      if constexpr (FORM == INV) {
        mma3<BN>(part, ahi[0], alo[0], dhi, dlo, 0);
        mma3<BN>(part2, ahi[1], alo[1], dhi + 2, dlo + 2, 0);
      } else {
#pragma unroll
        for (int step = 0; step < 2; ++step)
          mma3<BN>(part, ahi[step], alo[step], dhi + 2 * step,
                   dlo + 2 * step, step);
      }
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
      const int hcur = hb;
      if (++kc == nk) {
        kc = 0;
        hb ^= NH - 1;
      }
      if (c + 1 < nkc) load_a(kc, st1, ph1, nhi, nlo, mhi, mlo);
      wgmma_wait();
      fence_acc(part);
      fence_reg(ahi);
      fence_reg(alo);
      if constexpr (FORM == INV) fence_acc(part2);
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
#pragma unroll
        for (int i = 0; i < NV; ++i) part[i] += part2[i];
        if (hcur) {
#pragma unroll
          for (int i = 0; i < NV; ++i) acc2[i] += part[i];
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += part[i];
    }
    // the item's outputs: d[4 j + 2 c + q] is (A row gid + 8 c: column 4
    // ach[c] + (gid & 3) of the box, z line ach[c] of it; output row 8 j +
    // 2 tig + q of the tile); group g: the output half (FWD E, O; INV a +
    // b, a - b); SUB reads its s first, then stores (DENSE in two passes
    // of half the rows: with all 64 of s live beside the 64 sums its
    // instance spilled); SOLVE scales each sum by its mode's -1 / waves
    // (the pipeline's _pipe_b_kernel, pallas_poisson.py:1440-1443)
    constexpr int G = FORM == DENSE ? 1 : 2;
    const Item m = item_of(j);
    const int nrows = a.rows - m.rt * BN < BN ? a.rows - m.rt * BN : BN;
    float* const out = a.out[m.job];
    const long long base = m.c0 + box * FBOX;
    const long long col[2] = {
        base + (LINES ? ach[0] : 4 * ach[0] + (gid & 3)),
        base + (LINES ? ach[1] : 4 * ach[1] + (gid & 3))};
    const bool okc[2] = {col[0] < a.ncols, col[1] < a.ncols};
    const long long plane0 = (long long)m.plane * a.n_out * a.ncols;
    // the element (group g, tile row n) of column (z: line) c
    auto at = [&](int g, int n, int c) {
      const long long row = (long long)g * a.rows + m.rt * BN + n;
      return LINES ? col[c] * a.n_out + row
                   : plane0 + row * a.ncols + col[c];
    };
    auto value = [&](int g, int i) {
      float v = acc[i];
      if constexpr (FORM == FWD) v = g == 0 ? acc[i] : acc2[i];
      if constexpr (FORM == INV) v = g == 0 ? v + acc2[i] : v - acc2[i];
      return v;
    };
    if constexpr (LINES) {
      // rows 2 tig and 2 tig + 1 of each 8 are neighbours along the line:
      // 8 bytes a thread (rows is even, so a pair is stored whole or not);
      // no SUB in this layout
      static_assert(EPI == STORE, "the z layout only stores");
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < NV; i += 2) {
          const int n = (i >> 2) * 8 + 2 * tig;
          const int c = (i >> 1) & 1;
          if (n >= nrows || !okc[c]) continue;
          *reinterpret_cast<float2*>(out + at(g, n, c)) =
              make_float2(value(g, i), value(g, i + 1));
        }
    } else {
      const float* const sp = a.s[m.job];
      constexpr int PASSES = EPI == SUB && G == 1 ? 2 : 1;
      constexpr int NPI = NV / PASSES;
      // SOLVE: the column tables of the thread's two columns
      float ta[2] = {0.f, 0.f}, tb[2] = {0.f, 0.f};
      if constexpr (EPI == SOLVE) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (okc[c]) {
            ta[c] = __ldg(a.tab[0] + col[c]);
            tb[c] = __ldg(a.tab[1] + col[c]);
          }
      }
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        float sv[EPI == SUB ? G * NPI : 1];
        if constexpr (EPI == SUB) {
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int i0 = 0; i0 < NPI; ++i0) {
              const int i = pass * NPI + i0;
              const int n = (i >> 2) * 8 + 2 * tig + (i & 1);
              const int c = (i >> 1) & 1;
              sv[g * NPI + i0] =
                  n < nrows && okc[c] ? __ldg(sp + at(g, n, c)) : 0.f;
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i0 = 0; i0 < NPI; ++i0) {
            const int i = pass * NPI + i0;
            const int n = (i >> 2) * 8 + 2 * tig + (i & 1);
            const int c = (i >> 1) & 1;
            if (n >= nrows || !okc[c]) continue;
            float v = value(g, i);
            if constexpr (EPI == SUB) v = sv[g * NPI + i0] - v;
            if constexpr (EPI == SOLVE) {
              const int row = g * a.rows + m.rt * BN + n;
              const float waves = __ldg(a.tab[2] + row) * ta[c]
                                  + __ldg(a.tab[3] + row) * tb[c];
              v *= fabsf(waves) >= 1e-16f ? -1.f / waves : 0.f;
            }
            out[at(g, n, c)] = v;
          }
      }
    }
  }
}

// One launch of an instance at `bytes` of dynamic shared memory; the
// instance's attribute is raised to SMEM_MAX once per device
template <int FORM, int EPI, bool LINES>
cudaError_t launch(const TcArgs& a, const TcMaps& maps, int grid, int bytes,
                   cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEV || !ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(x_apply_tc_kernel<FORM, EPI, LINES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEV) ready[dev].store(true, std::memory_order_release);
  }
  x_apply_tc_kernel<FORM, EPI, LINES><<<grid, NTHR, bytes, stream>>>(a, maps);
  return cudaGetLastError();
}

// a field's tensor map: x and y (nplanes, n_in, ncols) float32, boxes of
// KC rows of FBOX columns, 128-byte swizzled; z (ncols lines, n_in), boxes
// of FBOX lines of KC, 64-byte swizzled; zeros past the extents (the
// driver's encoder, found through the runtime: no link to the driver
// library)
cudaError_t field_map(CUtensorMap* map, const void* f, bool lines,
                      long long n_in, long long ncols, long long nplanes) {
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
  const long long inner = lines ? n_in : ncols, outer = lines ? ncols : n_in;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)nplanes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4,
                                 (cuuint64_t)inner * outer * 4};
  const cuuint32_t boxd[3] = {lines ? (cuuint32_t)KC : (cuuint32_t)FBOX,
                              lines ? (cuuint32_t)FBOX : (cuuint32_t)KC, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(f), dims,
      strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      lines ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Compile-time geometry, for the wrapper's packing and checks: plane
// columns an item, k a chunk, the staged field row, the most stages,
// threads a block, the fixed dynamic shared memory, a block's most, then
// output rows an item, bytes of an operator block and bytes of a stage for
// DENSE, FWD, INV, then the most jobs a launch and sources a job.
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
  g[16] = MAX_JOBS;
  g[17] = MAX_SRC;
  return 0;
}

// One launch of njobs (1 .. MAX_JOBS) jobs. form: 0 dense, 1 parity
// forward, 2 parity inverse; lines: 0 the x and y layouts (f (nplanes,
// n_in, ncols)), 1 the z layout (f (ncols lines, n_in), nplanes 1; FWD and
// INV, K and rows even, no s); n_in = K (DENSE) or 2 K. ptrs: 2 MAX_SRC + 2
// pointers a job: its sources' packed operators (ops/x_apply_manual.py
// pack; rows output rows a part, contraction K; the second null for one
// source), their fields (likewise), s (null without the subtraction: all
// jobs or none) and the output (n_out = rows x (1 or 2) rows). tabs: null,
// or the solve's four float32 tables A, B (ncols each), k2x, tx2 (n_out
// each) for the FWD form in the x layout (nplanes 1, no s). ncols a
// multiple of 4 in the x and y layouts; slots 2 .. MAX_S where the ring
// fits (FWD 2 .. 7); grid: blocks (the SM count). Returns the cudaError_t
// of the launch (0 on success).
int x_apply_tc_launch_jobs(int form, int lines, int njobs,
                           const void* const* ptrs, const void* const* tabs,
                           int rows, int K, long long ncols, int nplanes,
                           int slots, int grid, void* stream) {
  constexpr int NPTR = 2 * MAX_SRC + 2;
  if (form < DENSE || form > INV || lines < 0 || lines > 1 || njobs < 1
      || njobs > MAX_JOBS || rows < 1 || K < 1 || ncols < 1 || nplanes < 1
      || slots < 2 || slots > MAX_S || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (lines ? (form == DENSE || K % 2 || rows % 2 || nplanes != 1)
            : (ncols < 4 || ncols % 4))
    return (int)cudaErrorInvalidValue;
  const bool sub = ptrs[MAX_SRC * 2] != nullptr;
  if ((form == FWD || lines) && sub) return (int)cudaErrorInvalidValue;
  const bool solve = tabs != nullptr;
  if (solve && (form != FWD || lines || nplanes != 1))
    return (int)cudaErrorInvalidValue;
  const int bn = tile_rows(form);
  const long long n_in = (long long)K * (form == DENSE ? 1 : 2);
  TcArgs a = {};
  TcMaps maps = {};
  for (int j = 0; j < njobs; ++j) {
    const void* const* p = ptrs + j * NPTR;
    if ((p[MAX_SRC * 2] != nullptr) != sub || p[0] == nullptr
        || p[MAX_SRC] == nullptr || p[MAX_SRC * 2 + 1] == nullptr)
      return (int)cudaErrorInvalidValue;
    a.nsrc[j] = 0;
    for (int src = 0; src < MAX_SRC; ++src) {
      if (p[src] == nullptr) break;
      if (p[MAX_SRC + src] == nullptr) return (int)cudaErrorInvalidValue;
      a.op[j][src] = static_cast<const float*>(p[src]);
      const cudaError_t e = field_map(&maps.m[j][src], p[MAX_SRC + src],
                                      lines, n_in, ncols, nplanes);
      if (e != cudaSuccess) return (int)e;
      ++a.nsrc[j];
    }
    a.s[j] = static_cast<const float*>(p[MAX_SRC * 2]);
    a.out[j] = static_cast<float*>(const_cast<void*>(p[MAX_SRC * 2 + 1]));
  }
  for (int i = 0; i < 4; ++i) {
    a.tab[i] = solve ? static_cast<const float*>(tabs[i]) : nullptr;
    if (solve && a.tab[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.rows = rows;
  a.n_out = rows * (form == DENSE ? 1 : 2);
  a.K = K;
  a.rtiles = (rows + bn - 1) / bn;
  a.ktiles = (K + KC - 1) / KC;
  a.ncols = ncols;
  const long long ctiles = (ncols + BM - 1) / BM;
  const long long per_job = ctiles * nplanes * a.rtiles;
  const int bytes = slots * stage_bytes(form) + SMEM_FIXED;
  if (per_job * njobs > 0x7FFFFFFFLL || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  a.ctiles = (int)ctiles;
  a.items_job = (int)per_job;
  a.nitems = (int)(per_job * njobs);
  a.slots = slots;
  if (grid > a.nitems) grid = a.nitems;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epi = sub ? SUB : solve ? SOLVE : STORE;
  switch ((form * 3 + epi) * 2 + lines) {
    case (DENSE * 3 + STORE) * 2:
      return (int)launch<DENSE, STORE, false>(a, maps, grid, bytes, st);
    case (DENSE * 3 + SUB) * 2:
      return (int)launch<DENSE, SUB, false>(a, maps, grid, bytes, st);
    case (FWD * 3 + STORE) * 2:
      return (int)launch<FWD, STORE, false>(a, maps, grid, bytes, st);
    case (FWD * 3 + STORE) * 2 + 1:
      return (int)launch<FWD, STORE, true>(a, maps, grid, bytes, st);
    case (FWD * 3 + SOLVE) * 2:
      return (int)launch<FWD, SOLVE, false>(a, maps, grid, bytes, st);
    case (INV * 3 + STORE) * 2:
      return (int)launch<INV, STORE, false>(a, maps, grid, bytes, st);
    case (INV * 3 + STORE) * 2 + 1:
      return (int)launch<INV, STORE, true>(a, maps, grid, bytes, st);
    case (INV * 3 + SUB) * 2:
      return (int)launch<INV, SUB, false>(a, maps, grid, bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* x_apply_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
