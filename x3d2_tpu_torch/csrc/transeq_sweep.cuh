// Directional transport sweeps for Hopper (sm_90a), behind a plain C
// interface: the momentum sweep with accumulate and a fused time-update
// epilogue (Adams-Bashforth or a Runge-Kutta substage), in two bodies (a
// tensor-core one and a SIMT one, see below), its xdiv variant, and the
// passive-scalar (species) sweep. This header holds the kernels,
// templated on the block geometry (BS output points per block, band
// half-width W); each geometry is its own translation unit and library,
// so nvcc builds them in parallel:
//   - transeq_sweep.cu      BS = 64, W = 16 (x3d2_tpu's default mode,
//     terms = 2), with the reduced-precision (bfloat16) instances;
//   - transeq_sweep_tc.cu   the tensor-core momentum sweep, BS = 64, W = 16;
//   - transeq_sweep_w32.cu  BS = 32, W = 32 (x3d2_tpu's HIGHEST mode,
//     X3D2_MATMUL_PRECISION=highest, terms = 3: w = 32 on the non-lane
//     axes, pallas_kernels.py:484, :747, :1131), with the same
//     reduced-precision instances.
//
// Replaces three TPU kernels of x3d2_tpu, which compute two functions:
//   - _pencil_kernel      x3d2_tpu/ops/pallas_kernels.py:671  (z sweep)
//   - _transeq_kernel_v3  x3d2_tpu/ops/pallas_kernels.py:172  (x/y sweeps,
//     accumulate, and the ab_olds / upd / base_sep epilogue of the final y
//     sweep)
//   - _species_kernel_v3  x3d2_tpu/ops/pallas_kernels.py:1038 (species)
//
// For every line along the sweep axis and every component q of (u, v, w):
//   r = -1/2 (conv * D1 q + D1d (q * conv)) + nu * D2 q   [+ acc]
// where conv is the component aligned with the axis. D1, D2 and D1d are the
// band-truncated resolved compact operators, given as per-output-block
// slices (ops/banded.py): for output block b of BS points, the window of
// BS + 2W input points starting at b*BS - W (periodic wrap).
//   sa = [D1; D2] (nb, 2BS, WIN) and da = D1s (nb, BS, WIN) for the aligned
//   component; st = [D1s; D2s] and dt = D1 for the transverse ones.
// With UPD the epilogue also writes rhs = r and
//   u' = base + dtc0 * r + sum_j dtc_{j+1} * old_j,
// the Adams-Bashforth update (base = the sweep's own u, olds = the
// derivative history) or the Runge-Kutta substage update (make_fused_
// transeq_rk, pallas_kernels.py:944-995: olds = the earlier stage
// derivatives with a nonzero coefficient, NOLDS = 0, 2 or 3 for the RK1-4
// tableaus; base = u at the first substage, else the step-initial field f0,
// read as three more row streams: BASE_SEP). u' never aliases u (other
// blocks read its windows) or f0 (later substages read it); rhs may alias
// acc.
// Reduced precision (PREC, template flags; x3d2_tpu's olds_dtype and
// acc_dtype, X3D2_BF16_OLDS and X3D2_BF16_ACC, pallas_kernels.py:304-326,
// :448-460): with OLDS_BF16 the AB history is read as bfloat16 and widened
// before its coefficient multiply, rhs is stored rounded to bfloat16
// (round to nearest even, as astype and torch's .to do), and the update
// gains the error feedback dtc4 * (r - bf16(r)), in the order
//   u' = base + dtc0 r + sum_j dtc_{j+1} old_j + dtc4 (r - bf16(r));
// with ACC_BF16 the cross-direction partials are bfloat16: the accumulate
// input is read as bfloat16 and widened, a sweep without the update stores
// its partial rounded to bfloat16. Arithmetic stays float32 in registers.
// The xdiv variant (the x sweep with the AB epilogue only; the xdiv variant
// of _transeq_kernel_v3, pallas_kernels.py:202-211, :327-364) also emits
// the projection's forward x transforms of the updated velocities,
//   du = [Me_s (u'1 + u'2); Mo_s (u'1 - u'2)], dv, dw likewise with Ix,
// modes in block-parity order: x block b of u' contributes
// Me[:, cols(b)] u'_b to the even modes and +/- Mo[:, cols(b)] u'_b to the
// odd ones (sign by input half), summed over the nb blocks of x.
// The species sweep computes, for each of nsp <= 8 scalars phi_s with its
// own diffusivity nu_s, the aligned component's function with conv the
// velocity component along the axis:
//   r_s = -1/2 (conv * D1 phi_s + D1s (phi_s * conv)) + nu_s * D2 phi_s
//         [+ acc_s].
//
// Bound on an H100 (W = 16; W = 32 in brackets): the function needs the
// 2W + 1 = 33 [65] band taps of each operator, 3 components x 3 operators
// x 33 = 297 [585] FMA per point, about 1.2 [2.4] ms per 512^3 sweep at
// the 67 TFLOP/s FP32 rate; the 6, 9 and 18 field passes of the z, x+acc
// and y+acc+AB3 sweeps take 0.96, 1.44 and 2.88 ms at 3.35 TB/s. The
// kernel's block rows are BS + 2W = 96 wide in both geometries (864 FMA
// per point, 2.9x [1.5x] the need): a choice of this design, which keeps
// each block's operators dense, not a need of the function. The species sweep
// with 2 scalars needs 198 FMA per point and moves 5 (z) or 7 (x, y +
// acc) field passes: 0.82 ms of operations and 1.12 ms of bytes at 512^3.
//
// Two bodies compute the momentum sweep. The tensor-core body
// (transeq_sweep_tc_kernel, the default mode's geometry only) serves every
// momentum sweep of a uniform periodic axis but the xdiv variant and the
// halo form: the z sweep (_pencil_kernel) and the x and y sweeps with
// their accumulate and update epilogues (_transeq_kernel_v3), at every
// precision. The SIMT body (transeq_sweep_kernel, described after it)
// serves the HIGHEST mode's W = 32, the halo form, and the axes whose
// operators are not circulant (a non-periodic axis: its closure rows
// differ from slice to slice), which the wrapper routes to it when it
// builds the blocks (ops/transeq_sweep.py tc_route).
//
// The tensor-core body. What bounds it: its split-TF32 products of the
// band taps (3 x 297 multiply-adds a point: 0.50 ms a 512^3 sweep at the
// 495 TFLOP/s TF32 rate) are below the bytes of every instance (0.96,
// 1.44, 2.88 ms for z, x + acc, y + acc + AB3): bound by bytes. What its
// design does about it: it contracts the band, not the block. Each
// 16-row slice of an output block takes the 48 window columns of its band
// (three chunks of 16; every row keeps its +/- W taps), half the dense
// block's work. On a circulant operator every slice of every block has
// the same rows over its band, so three images a pairing (TF32 hi and lo
// of [D1; D2] and D1d rows, as wgmma reads them: 36 KB) serve a launch,
// staged once a block, and two stages of the u, v, w windows (144 KB) fit
// beside them: the next tile's windows arrive by cp.async straight into
// shared memory while a tile computes. Two warpgroups take two slices
// each; the field window is the A operand, split to TF32 in registers (hi
// rounded to nearest, lo truncated by the tensor cores), q conv formed as
// it loads, each chunk's fragments loaded once for both slices of a
// warpgroup; the [D1; D2] (n32) and D1d (n16) products, three a k step
// (lo hi, hi lo, hi hi), are issued a chunk ahead of their wait, and the
// tensor cores sum a slice over its band into FP32 registers (3-4e-7 of
// max |plain f64|; not plain float32's bits). The epilogue works from the
// accumulator layout (8 outputs a thread a slice; along z pairs of
// neighbouring rows, 8 bytes), its streams loaded as the component starts.
// 185 KB of shared memory, 256 threads, one block an SM.
//
// The SIMT body (and the species sweep's). What its design does about the
// bound: a block stages both operator pairings of its output block (147
// KB at BS = 64; 74 KB at BS = 32) once and walks
// many line tiles with them, so the operators cost no device-memory
// traffic per tile. Each thread keeps an RPT-row x 2-line register tile of
// three accumulators (RPT = BS / 8: 8 rows, 4 at BS = 32), so one k step
// does 6 RPT FMAs against 3 RPT / 4 broadcast 16-byte shared-memory loads
// of operator rows and 4 conflict-free loads of field values. The field
// window of a 64-line tile (3 x 96 x 64 floats) is read from device
// memory once, and the next tile's windows load into registers while the
// current tile computes (one block per SM, so the overlap is within the
// block).
//
// Why BS = 32 at W = 32: the window BS + 2W stays 96, so a block holds its
// operators (74 KB) and three windows (75 KB) in 149 KB of the 227 KB an
// SM allows, and each output point costs the same 96 FMA per operator as
// at W = 16. At BS = 64 the window would be 128 wide: 196 KB of operators
// alone. The price: twice the operator blocks per axis (n / 32), and
// half the FMA per field load in the k loop.
//
// The species sweep keeps what the TPU kernel exists for (pallas_kernels.py
// :1028-1035): the conv window is read from device memory once per tile for
// all scalars. It stages only the aligned pairing (sa, da: 74 KB); a tile's
// conv window stays resident while the block walks the scalars through a
// second window. The next scalar's window (or, after the last, the next
// tile's conv and first scalar: two windows for one scalar's compute) is
// in flight meanwhile by asynchronous copies straight into a second buffer
// of each window, so no registers hold it: 172 KB of shared memory (137 KB
// at BS = 32), one block per SM.
//
// The halo form (HALO, the sharded sweeps of x3d2_tpu's make_sharded_
// transeq_v3 and make_sharded_species_v3, shard_kernels.py:105-207; the
// halo_ext kernels, pallas_kernels.py:238-252, :404-427, :1061-1070): the
// fields are one rank's shard along the sweep axis, and the windows are
// read from the halo-extended operands instead, each the shard with the
// W planes of the previous rank before it and the W planes of the next
// rank after it (n + 2W along the sweep axis). The window of output block b
// starts at b*BS there and never wraps. The operator blocks are the global
// stack's, from this shard's first block (the wrapper passes the stack at
// its block offset), so the closure rows of a non-periodic axis fall on the
// ranks that own them. Outputs, partials and the conv rows of the combine
// are the shard's. Built without the time update (x3d2_tpu shards only
// the partial sweeps; the update is elementwise there).
//
// The xdiv variant is a kernel of its own (transeq_xdiv_kernel). The TPU
// kernel carries the sum over x blocks in scratch memory along its
// sequential innermost grid axis; blocks of a CUDA grid run in no order.
// So here one block owns a line tile over the whole of x: per component it
// walks the nb x blocks in order, and each thread keeps its share of the
// transform's result (n modes x 64 lines per block: 64 accumulators a
// thread at n = 256 in both geometries, n / BS passes of RPT rows x 2
// lines: 4 passes of 8 rows at BS = 64, 8 of 4 at BS = 32) in registers
// across them, then writes du, dv or dw once. No partial sums leave the chip, nothing is reduced across blocks
// and no atomics are used, so a run repeats bit for bit. On a uniform
// periodic axis the operator blocks of all x blocks are equal (the
// operators are circulant and BS divides n; the wrapper checks it), so
// the block stages them once, as the sweep does. After a block's sweep
// epilogue u'_b goes from registers to shared memory, and the block's BS
// columns of the transform pass through 8 KB of shared memory, 8 rows of
// k at a time, the next chunk in flight from L2 meanwhile. The price of
// the component-outer order is that the conv window (u) is read once per
// component: 5 window reads per x block where the sweep needs 3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace sweep {

// PREC flags of the sweep kernels
constexpr int OLDS_BF16 = 1;      // history in, rhs out as bfloat16
constexpr int ACC_BF16 = 2;       // partials in (and out without UPD)

constexpr int TL = 64;            // lines per tile
constexpr int NT = 256;           // threads per block
constexpr int XDIV_MAX_N = 256;   // xdiv: most points along x
constexpr int XK = 8;             // xdiv: rows of the transform per chunk
constexpr int MAX_SPECIES = 8;    // scalars per species launch

// The block geometry: BS output points per block along the sweep, band
// half-width W.
template <int BS, int W>
struct Geo {
  static constexpr int WIN = BS + 2 * W;         // window length
  static constexpr int RPT = BS / (NT / 32);     // output rows per thread
  static constexpr int PER_THREAD = WIN * TL / NT;  // window elements
  // xdiv: passes of the 8 warps over the modes, BS modes a pass (64
  // accumulators a thread at n = 256)
  static constexpr int XDIV_NP = XDIV_MAX_N / BS;
  static constexpr int MAT_FLOATS = 2 * (WIN * 2 * BS) + 2 * (WIN * BS);
  static_assert(RPT % 4 == 0 && RPT * (NT / 32) == BS,
                "each warp owns RPT rows, a multiple of a float4");
  static_assert(WIN * TL % NT == 0, "threads must tile the window");
  static_assert(XK * XDIV_MAX_N <= (WIN - BS) * TL &&
                    XK * XDIV_MAX_N / 4 <= 2 * NT && BS % XK == 0,
                "a chunk of the transform must fit beside u'_b in one window");
};

struct SweepArgs {
  const float* f[3];               // u, v, w (HALO: the extended operands)
  const float* sa;
  const float* st;
  const float* da;
  const float* dt;
  const void* acc[3];              // float, or bfloat16 with ACC_BF16
  const void* old[3][3];           // old[j][c]; bfloat16 with OLDS_BF16
  void* out[3];                    // r (bfloat16 with ACC_BF16), or u'
  void* rhs[3];                    // UPD only; bfloat16 with OLDS_BF16
  int n0, n1, n2;
  float nu;
  float dtc[5];                    // [4]: the error feedback (OLDS_BF16)
  // xdiv only
  const float* xm[2];              // Sx, Ix slices [nb][BS][n0], sign folded
  float* div[3];                   // du, dv, dw
  // BASE_SEP only: the update's base (the RK step-initial fields)
  const float* base[3];
};

struct SpeciesArgs {
  const float* conv;               // the velocity component along the axis
                                   // (HALO: conv and phi extended)
  const float* sa;                 // [D1; D2] (nb, 2BS, WIN)
  const float* da;                 // D1s (nb, BS, WIN)
  const float* phi[MAX_SPECIES];
  const float* acc[MAX_SPECIES];   // ACC only
  float* out[MAX_SPECIES];
  float nu[MAX_SPECIES];
  int nsp;
  int n0, n1, n2;
};

template <int AXIS>
__host__ __device__ constexpr int ldw() {
  // z-sweep windows are written to shared memory along the sweep index:
  // one pad column keeps those transposing stores free of bank conflicts
  return AXIS == 2 ? TL + 1 : TL;
}

template <int BS, int W, int AXIS>
constexpr size_t smem_bytes() {
  using G = Geo<BS, W>;
  return sizeof(float) * (size_t)(G::MAT_FLOATS + 3 * G::WIN * ldw<AXIS>());
}

// the species sweep: the aligned pairing, and two buffers each of the conv
// window and of one scalar's
template <int BS, int W, int AXIS>
constexpr size_t species_smem_bytes() {
  using G = Geo<BS, W>;
  return sizeof(float) * (size_t)(G::WIN * 2 * BS + G::WIN * BS +
                                  4 * G::WIN * ldw<AXIS>());
}

// Offsets of one line tile: element (line l, sweep index g) of a field is
// at base + l * lstride + g * sstride.
template <int AXIS>
__device__ __forceinline__ void tile_geometry(int n0, int n1_, int n2_,
                                              long long t, long long& base,
                                              long long& lstride,
                                              long long& sstride, int& n) {
  const long long n1 = n1_, n2 = n2_;
  if (AXIS == 0) {
    n = n0;
    base = t * TL;
    lstride = 1;
    sstride = n1 * n2;
  } else if (AXIS == 1) {
    n = n1_;
    const long long per = n2 / TL;
    base = (t / per) * n1 * n2 + (t % per) * TL;
    lstride = 1;
    sstride = n2;
  } else {
    n = n2_;
    base = t * TL * n2;
    lstride = n2;
    sstride = 1;
  }
}

// The same tile in the operand the windows are read from: the field itself,
// or with HALO its extension by W planes on both sides of the sweep axis.
template <int AXIS, bool HALO, int W>
__device__ __forceinline__ void source_geometry(int n0, int n1, int n2,
                                                long long t, long long& base,
                                                long long& lstride,
                                                long long& sstride, int& n) {
  constexpr int E = HALO ? 2 * W : 0;
  tile_geometry<AXIS>(n0 + (AXIS == 0 ? E : 0), n1 + (AXIS == 1 ? E : 0),
                      n2 + (AXIS == 2 ? E : 0), t, base, lstride, sstride, n);
}

// Window element i of a tile as (sweep index k, line l): consecutive i run
// along the contiguous axis of the field (k for the z sweep, l otherwise),
// so consecutive threads read consecutive addresses.
template <int WIN, int AXIS>
__device__ __forceinline__ void window_coords(int i, int& k, int& l) {
  if (AXIS == 2) {
    l = i / WIN;
    k = i - l * WIN;
  } else {
    k = i / TL;
    l = i - k * TL;
  }
}

// Offset from the tile base of window element (k, l), periodic along the
// sweep (n >= W, so one wrap suffices).
template <int AXIS>
__device__ __forceinline__ long long window_offset(int k, int l, int k0,
                                                   int n, long long ls,
                                                   long long ss) {
  int g = k0 + k;
  g = g < 0 ? g + n : (g >= n ? g - n : g);
  return AXIS == 2 ? (long long)l * ls + g : (long long)g * ss + l;
}

// A thread's share of the window of field f for the tile at base, into
// registers (a load that can be in flight while the block computes)...
template <int BS, int W, int AXIS>
__device__ __forceinline__ void fetch_window(
    const float* f, long long base, int k0, int n, long long ls, long long ss,
    float (&pre)[Geo<BS, W>::PER_THREAD]) {
  using G = Geo<BS, W>;
#pragma unroll
  for (int m = 0; m < G::PER_THREAD; ++m) {
    int k, l;
    window_coords<G::WIN, AXIS>(threadIdx.x + m * NT, k, l);
    pre[m] = f[base + window_offset<AXIS>(k, l, k0, n, ls, ss)];
  }
}

// ...and from registers into the window's place in shared memory.
template <int BS, int W, int AXIS>
__device__ __forceinline__ void put_window(
    float* dst, const float (&pre)[Geo<BS, W>::PER_THREAD]) {
  using G = Geo<BS, W>;
#pragma unroll
  for (int m = 0; m < G::PER_THREAD; ++m) {
    int k, l;
    window_coords<G::WIN, AXIS>(threadIdx.x + m * NT, k, l);
    dst[k * ldw<AXIS>() + l] = pre[m];
  }
}

// A thread's share of the window of field f straight into shared memory
// by asynchronous copies (cp.async, no registers held); complete after
// cp_async_wait() and a barrier.
template <int BS, int W, int AXIS>
__device__ __forceinline__ void copy_window_async(float* dst, const float* f,
                                                  long long base, int k0,
                                                  int n, long long ls,
                                                  long long ss) {
  using G = Geo<BS, W>;
#pragma unroll 4
  for (int m = 0; m < G::PER_THREAD; ++m) {
    int k, l;
    window_coords<G::WIN, AXIS>(threadIdx.x + m * NT, k, l);
    const unsigned to = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + k * ldw<AXIS>() + l));
    const float* from = f + base + window_offset<AXIS>(k, l, k0, n, ls, ss);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                 "l"(from)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The RPT output rows of one line at row0 (stride ss along the sweep):
// along z they are contiguous and 16-byte aligned, RPT / 4 float4 accesses.
template <int RPT, int AXIS>
__device__ __forceinline__ void load_rows(const float* p, long long row0,
                                          long long ss, float (&v)[RPT]) {
  if (AXIS == 2) {
#pragma unroll
    for (int h = 0; h < RPT / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(p + row0 + 4 * h);
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z; v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) v[r] = p[row0 + r * ss];
  }
}

template <int RPT, int AXIS>
__device__ __forceinline__ void store_rows(float* p, long long row0,
                                           long long ss, const float (&v)[RPT]) {
  if (AXIS == 2) {
#pragma unroll
    for (int h = 0; h < RPT / 4; ++h)
      *reinterpret_cast<float4*>(p + row0 + 4 * h) =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) p[row0 + r * ss] = v[r];
  }
}

// The same rows of a float or (BF) bfloat16 field, widened to or rounded
// from float32 (round to nearest even). Along z a thread's RPT bfloat16
// rows are one aligned access (16 bytes at RPT = 8).
template <int RPT, int AXIS, bool BF>
__device__ __forceinline__ void load_rows_as(const void* p, long long row0,
                                             long long ss, float (&v)[RPT]) {
  if constexpr (!BF) {
    load_rows<RPT, AXIS>(static_cast<const float*>(p), row0, ss, v);
  } else {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p);
    if constexpr (AXIS == 2) {
      using V = typename std::conditional<RPT == 8, uint4, uint2>::type;
      static_assert(RPT == 8 || RPT == 4, "one 8- or 16-byte access");
      const V x = *reinterpret_cast<const V*>(q + row0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < RPT / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r) v[r] = __bfloat162float(q[row0 + r * ss]);
    }
  }
}

template <int RPT, int AXIS, bool BF>
__device__ __forceinline__ void store_rows_as(void* p, long long row0,
                                              long long ss,
                                              const float (&v)[RPT]) {
  if constexpr (!BF) {
    store_rows<RPT, AXIS>(static_cast<float*>(p), row0, ss, v);
  } else {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p);
    if constexpr (AXIS == 2) {
      using V = typename std::conditional<RPT == 8, uint4, uint2>::type;
      static_assert(RPT == 8 || RPT == 4, "one 8- or 16-byte access");
      V x;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < RPT / 2; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<V*>(q + row0) = x;
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        q[row0 + r * ss] = __float2bfloat16_rn(v[r]);
    }
  }
}

// Stage one operator pairing of output block b (s: [D1; D2]-shaped, d: one
// BS-row operator), transposed to [k][row] so that a thread's RPT rows at
// one k are RPT / 4 aligned float4 loads.
template <int BS, int W>
__device__ __forceinline__ void stage_pairing(const float* s, const float* d,
                                              int b, float* ST, float* DT) {
  constexpr int WIN = Geo<BS, W>::WIN;
  const int tid = threadIdx.x;
  s += (size_t)b * 2 * BS * WIN;
  for (int i = tid; i < 2 * BS * WIN; i += NT) {
    const int row = i / WIN, k = i - (i / WIN) * WIN;
    ST[k * 2 * BS + row] = s[i];
  }
  d += (size_t)b * BS * WIN;
  for (int i = tid; i < BS * WIN; i += NT) {
    const int row = i / WIN, k = i - (i / WIN) * WIN;
    DT[k * BS + row] = d[i];
  }
}

// Both pairings of the momentum sweep.
template <int BS, int W>
__device__ __forceinline__ void stage_operators(const SweepArgs& a, int b,
                                                float* SaT, float* StT,
                                                float* DaT, float* DtT) {
  stage_pairing<BS, W>(a.sa, a.da, b, SaT, DaT);
  stage_pairing<BS, W>(a.st, a.dt, b, StT, DtT);
}

// The contraction of one component's window Q (conv window CV, which is Q
// itself for the aligned component) with the block's operators: the
// thread's RPT rows (from r0) x 2 lines (tx, tx + 32) of D1 q, D2 q and
// D1d (q * conv).
template <int BS, int W, int LDW>
__device__ __forceinline__ void contract(
    const float* Q, const float* CV, const float* S, const float* D, int tx,
    int r0, float (&dq)[Geo<BS, W>::RPT][2], float (&d2)[Geo<BS, W>::RPT][2],
    float (&dd)[Geo<BS, W>::RPT][2]) {
  constexpr int RPT = Geo<BS, W>::RPT;
  constexpr int WIN = Geo<BS, W>::WIN;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      dq[r][j] = 0.f;
      d2[r][j] = 0.f;
      dd[r][j] = 0.f;
    }
  }
#pragma unroll 4
  for (int k = 0; k < WIN; ++k) {
    const float q0 = Q[k * LDW + tx];
    const float q1 = Q[k * LDW + tx + 32];
    const float p0 = q0 * CV[k * LDW + tx];
    const float p1 = q1 * CV[k * LDW + tx + 32];
    float m1[RPT], m2[RPT], m3[RPT];
    const float4* s1 = reinterpret_cast<const float4*>(S + k * 2 * BS + r0);
    const float4* s2 =
        reinterpret_cast<const float4*>(S + k * 2 * BS + BS + r0);
    const float4* s3 = reinterpret_cast<const float4*>(D + k * BS + r0);
#pragma unroll
    for (int h = 0; h < RPT / 4; ++h) {
      const float4 x1 = s1[h], x2 = s2[h], x3 = s3[h];
      m1[4 * h] = x1.x; m1[4 * h + 1] = x1.y;
      m1[4 * h + 2] = x1.z; m1[4 * h + 3] = x1.w;
      m2[4 * h] = x2.x; m2[4 * h + 1] = x2.y;
      m2[4 * h + 2] = x2.z; m2[4 * h + 3] = x2.w;
      m3[4 * h] = x3.x; m3[4 * h + 1] = x3.y;
      m3[4 * h + 2] = x3.z; m3[4 * h + 3] = x3.w;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      dq[r][0] = fmaf(m1[r], q0, dq[r][0]);
      dq[r][1] = fmaf(m1[r], q1, dq[r][1]);
      d2[r][0] = fmaf(m2[r], q0, d2[r][0]);
      d2[r][1] = fmaf(m2[r], q1, d2[r][1]);
      dd[r][0] = fmaf(m3[r], p0, dd[r][0]);
      dd[r][1] = fmaf(m3[r], p1, dd[r][1]);
    }
  }
}

// The combine of the thread's line j (window column l, rows from r0):
// r = -1/2 (conv dq + dd) + nu d2 [+ av].
template <int RPT, int W, bool ACC, int LDW>
__device__ __forceinline__ void line_rhs(float nu, int j, int l, int r0,
                                         const float* CV,
                                         const float (&dq)[RPT][2],
                                         const float (&d2)[RPT][2],
                                         const float (&dd)[RPT][2],
                                         const float (&av)[RPT],
                                         float (&res)[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float conv = CV[(W + r0 + r) * LDW + l];
    res[r] = -0.5f * (conv * dq[r][j] + dd[r][j]) + nu * d2[r][j];
    if (ACC) res[r] += av[r];
  }
}

// The epilogue of the thread's line j (window column l, rows from row0) of
// component c: combine, accumulate, time update, stores. acc, the history
// and the base may alias outputs (the same point, read before it is
// written), so the compiler cannot move a load above an earlier store:
// every load of a line is issued before its stores, one memory latency per
// line. With UPD, un returns u'. PREC: the bfloat16 streams (see the head
// of the file).
template <int BS, int W, int AXIS, bool ACC, int NOLDS, bool UPD,
          bool BASE_SEP, int PREC, int LDW>
__device__ __forceinline__ void combine_line(
    const SweepArgs& a, int c, int j, int l, int r0, long long row0,
    long long ss, const float* Q, const float* CV,
    const float (&dq)[Geo<BS, W>::RPT][2], const float (&d2)[Geo<BS, W>::RPT][2],
    const float (&dd)[Geo<BS, W>::RPT][2], float (&un)[Geo<BS, W>::RPT]) {
  constexpr int RPT = Geo<BS, W>::RPT;
  static_assert(UPD || (NOLDS == 0 && !BASE_SEP), "history needs UPD");
  constexpr bool OB = (PREC & OLDS_BF16) != 0;
  constexpr bool AB = (PREC & ACC_BF16) != 0;
  static_assert(!OB || (UPD && NOLDS > 0 && !BASE_SEP),
                "a bfloat16 history is the AB update's");
  float res[RPT], av[RPT], bv[RPT], ov[NOLDS > 0 ? NOLDS : 1][RPT];
  if (ACC) load_rows_as<RPT, AXIS, AB>(a.acc[c], row0, ss, av);
#pragma unroll
  for (int jj = 0; jj < NOLDS; ++jj)
    load_rows_as<RPT, AXIS, OB>(a.old[jj][c], row0, ss, ov[jj]);
  if (BASE_SEP) load_rows<RPT, AXIS>(a.base[c], row0, ss, bv);
  line_rhs<RPT, W, ACC, LDW>(a.nu, j, l, r0, CV, dq, d2, dd, av, res);
  if (UPD) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      un[r] = (BASE_SEP ? bv[r] : Q[(W + r0 + r) * LDW + l]) +
              a.dtc[0] * res[r];
#pragma unroll
      for (int jj = 0; jj < NOLDS; ++jj) un[r] += a.dtc[jj + 1] * ov[jj][r];
      if (OB) {
        // pre-pay the stored rhs's rounding while r is exact
        const float rs = __bfloat162float(__float2bfloat16_rn(res[r]));
        un[r] += a.dtc[4] * (res[r] - rs);
      }
    }
    store_rows_as<RPT, AXIS, OB>(a.rhs[c], row0, ss, res);
    store_rows_as<RPT, AXIS, false>(a.out[c], row0, ss, un);
  } else {
    store_rows_as<RPT, AXIS, AB>(a.out[c], row0, ss, res);
  }
}

template <int BS, int W, int AXIS, bool ACC, int NOLDS, bool UPD,
          bool BASE_SEP, int PREC, bool HALO>
__global__ void __launch_bounds__(NT, 1)
transeq_sweep_kernel(SweepArgs a, long long ntiles) {
  static_assert(!HALO || (!UPD && PREC == 0), "the halo form is a partial sweep");
  using G = Geo<BS, W>;
  constexpr int WIN = G::WIN, RPT = G::RPT;
  extern __shared__ __align__(16) float smem[];
  constexpr int LDW = ldw<AXIS>();
  float* SaT = smem;                    // [WIN][2BS]
  float* StT = SaT + WIN * 2 * BS;      // [WIN][2BS]
  float* DaT = StT + WIN * 2 * BS;      // [WIN][BS]
  float* DtT = DaT + WIN * BS;          // [WIN][BS]
  float* F = DtT + WIN * BS;            // [3][WIN][LDW]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  stage_operators<BS, W>(a, b, SaT, StT, DaT, DtT);

  const int tx = tid & 31;
  const int r0 = (tid >> 5) * RPT;
  const float* CV = F + AXIS * WIN * LDW;

  long long t = blockIdx.x;
  if (t >= ntiles) return;
  long long base, ls, ss;     // the outputs' tile
  long long sb, sls, sss;     // the windows' source tile
  int n, sn;
  tile_geometry<AXIS>(a.n0, a.n1, a.n2, t, base, ls, ss, n);
  source_geometry<AXIS, HALO, W>(a.n0, a.n1, a.n2, t, sb, sls, sss, sn);
  const int k0 = HALO ? b * BS : b * BS - W;
  // the first tile's windows
  for (int c = 0; c < 3; ++c) {
    float pre[G::PER_THREAD];
    fetch_window<BS, W, AXIS>(a.f[c], sb, k0, sn, sls, sss, pre);
    put_window<BS, W, AXIS>(F + c * WIN * LDW, pre);
  }
  __syncthreads();

  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    const bool has_next = tn < ntiles;
    long long nbase = 0, nls = 0, nss = 0, nsb = 0, nsls = 0, nsss = 0;
    int nn = n, nsn = sn;
    if (has_next) {
      tile_geometry<AXIS>(a.n0, a.n1, a.n2, tn, nbase, nls, nss, nn);
      source_geometry<AXIS, HALO, W>(a.n0, a.n1, a.n2, tn, nsb, nsls, nsss,
                                     nsn);
    }

    // the two transverse components first, the aligned one last: its
    // window is every component's conv. While a component computes, the
    // next tile's window of that component is in flight into registers;
    // it replaces the current one once all threads are done with it.
#pragma unroll 1
    for (int ci = 0; ci < 3; ++ci) {
      const int c = ci == 2 ? AXIS : ci + (ci >= AXIS ? 1 : 0);
      float pre[G::PER_THREAD];
      if (has_next)
        fetch_window<BS, W, AXIS>(a.f[c], nsb, k0, nsn, nsls, nsss, pre);

      const float* Q = F + c * WIN * LDW;
      float dq[RPT][2], d2[RPT][2], dd[RPT][2];
      contract<BS, W, LDW>(Q, CV, (c == AXIS) ? SaT : StT,
                           (c == AXIS) ? DaT : DtT, tx, r0, dq, d2, dd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = tx + 32 * j;
        const long long row0 = base + (AXIS == 2 ? l * ls : (long long)l) +
                               (long long)(b * BS + r0) * ss;
        float un[RPT];
        combine_line<BS, W, AXIS, ACC, NOLDS, UPD, BASE_SEP, PREC, LDW>(
            a, c, j, l, r0, row0, ss, Q, CV, dq, d2, dd, un);
      }

      __syncthreads();  // every thread is done reading window c
      if (has_next) put_window<BS, W, AXIS>(F + c * WIN * LDW, pre);
    }
    __syncthreads();  // the next tile's windows are complete
    base = nbase;
    ls = nls;
    ss = nss;
    n = nn;
    sb = nsb;
    sls = nsls;
    sss = nsss;
    sn = nsn;
  }
}

// The xdiv variant: the x sweep with accumulate and the AB epilogue, which
// also writes du = Sx u', dv = Ix v', dw = Ix w' (see the head of the
// file). Grid (blocks); a block owns whole line tiles, all of x.
template <int BS, int W, int NOLDS, int PREC>
__global__ void __launch_bounds__(NT, 1)
transeq_xdiv_kernel(SweepArgs a, long long ntiles) {
  using G = Geo<BS, W>;
  constexpr int WIN = G::WIN, RPT = G::RPT, NP = G::XDIV_NP;
  extern __shared__ __align__(16) float smem[];
  float* SaT = smem;
  float* StT = SaT + WIN * 2 * BS;
  float* DaT = StT + WIN * 2 * BS;
  float* DtT = DaT + WIN * BS;
  float* Qw = DtT + WIN * BS;           // [WIN][TL] the component's window
  float* Cw = Qw + WIN * TL;            // [WIN][TL] the conv (u) window
  float* U = Cw + WIN * TL;             // [BS][TL]  u'_b
  float* XS = U + BS * TL;              // [XK][n]   a chunk of the transform

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int r0 = (tid >> 5) * RPT;
  const int n = a.n0;
  const int nb = n / BS;
  const int npass = n / BS;             // BS modes per pass of the 8 warps
  const int chunk4 = XK * n / 4;        // float4 per chunk: at most 2 * NT
  const long long ss = (long long)a.n1 * a.n2;  // x stride; lines per field
  // every x block has the operators of block 0 (checked by the wrapper)
  stage_operators<BS, W>(a, 0, SaT, StT, DaT, DtT);

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long base = t * TL;
#pragma unroll 1
    for (int ci = 0; ci < 3; ++ci) {
      const int c = ci == 2 ? 0 : ci + 1;  // v, w, then the aligned u
      const float* Q = Qw;
      const float* CV = c == 0 ? Qw : Cw;
      float e[NP][RPT][2];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          e[p][r][0] = 0.f;
          e[p][r][1] = 0.f;
        }
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const float4* X4 = reinterpret_cast<const float4*>(
            a.xm[c == 0 ? 0 : 1] + (size_t)b * BS * n);
        float4 xr[2];
        auto fetch_x = [&](int kc) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (tid + q * NT < chunk4)
              xr[q] = __ldg(X4 + (size_t)kc * chunk4 + tid + q * NT);
        };
        auto stage_x = [&]() {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (tid + q * NT < chunk4)
              reinterpret_cast<float4*>(XS)[tid + q * NT] = xr[q];
        };
        // the windows of x block b (the barrier that ended the previous
        // block's transform freed them)
        const int k0 = b * BS - W;
#pragma unroll 8
        for (int m = 0; m < G::PER_THREAD; ++m) {
          int k, l;
          window_coords<WIN, 0>(tid + m * NT, k, l);
          const long long off = base + window_offset<0>(k, l, k0, n, 1, ss);
          Qw[k * TL + l] = a.f[c][off];
          if (c != 0) Cw[k * TL + l] = a.f[0][off];
        }
        fetch_x(0);
        __syncthreads();

        float dq[RPT][2], d2[RPT][2], dd[RPT][2];
        contract<BS, W, TL>(Q, CV, c == 0 ? SaT : StT, c == 0 ? DaT : DtT,
                            tx, r0, dq, d2, dd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int l = tx + 32 * j;
          const long long row0 = base + l + (long long)(b * BS + r0) * ss;
          float un[RPT];
          combine_line<BS, W, 0, true, NOLDS, true, false, PREC, TL>(
              a, c, j, l, r0, row0, ss, Q, CV, dq, d2, dd, un);
#pragma unroll
          for (int r = 0; r < RPT; ++r) U[(r0 + r) * TL + l] = un[r];
        }
        stage_x();
        __syncthreads();  // u'_b and the first chunk are in place

        // e += X_b^T u'_b: a warp takes RPT modes of every BS, a thread its
        // two lines
        for (int kc = 0; kc < BS / XK; ++kc) {
          if (kc + 1 < BS / XK) fetch_x(kc + 1);
#pragma unroll
          for (int kk = 0; kk < XK; ++kk) {
            const int k = kc * XK + kk;
            const float u0 = U[k * TL + tx];
            const float u1 = U[k * TL + tx + 32];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              if (p < npass) {
                const float4* xs = reinterpret_cast<const float4*>(
                    XS + kk * n + p * BS + r0);
                float xv[RPT];
#pragma unroll
                for (int h = 0; h < RPT / 4; ++h) {
                  const float4 x4 = xs[h];
                  xv[4 * h] = x4.x;
                  xv[4 * h + 1] = x4.y;
                  xv[4 * h + 2] = x4.z;
                  xv[4 * h + 3] = x4.w;
                }
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                  e[p][r][0] = fmaf(xv[r], u0, e[p][r][0]);
                  e[p][r][1] = fmaf(xv[r], u1, e[p][r][1]);
                }
              }
            }
          }
          __syncthreads();  // every thread is done reading this chunk
          if (kc + 1 < BS / XK) {
            stage_x();
            __syncthreads();
          }
        }
      }
      // the sum over the x blocks is complete: mode p * BS + r0 + r
      float* dst = a.div[c] + base;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p < npass) {
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const long long o = (long long)(p * BS + r0 + r) * ss;
            dst[o + tx] = e[p][r][0];
            dst[o + tx + 32] = e[p][r][1];
          }
        }
      }
    }
  }
}

// The species sweep (see the head of the file). Grid (blocks per output
// block, output blocks); a block stages its output block's aligned pairing
// and walks line tiles, and within a tile the scalars.
template <int BS, int W, int AXIS, bool ACC, bool HALO>
__global__ void __launch_bounds__(NT, 1)
species_sweep_kernel(SpeciesArgs a, long long ntiles) {
  using G = Geo<BS, W>;
  constexpr int WIN = G::WIN, RPT = G::RPT;
  extern __shared__ __align__(16) float smem[];
  constexpr int LDW = ldw<AXIS>();
  float* SaT = smem;                    // [WIN][2BS]
  float* DaT = SaT + WIN * 2 * BS;      // [WIN][BS]
  float* Cw = DaT + WIN * BS;           // [WIN][LDW] the conv window
  float* Qw = Cw + WIN * LDW;           // [WIN][LDW] one scalar's window
  float* Cn = Qw + WIN * LDW;           // the buffers the next windows
  float* Qn = Cn + WIN * LDW;           // arrive in

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  stage_pairing<BS, W>(a.sa, a.da, b, SaT, DaT);

  const int tx = tid & 31;
  const int r0 = (tid >> 5) * RPT;

  long long t = blockIdx.x;
  if (t >= ntiles) return;
  long long base, ls, ss;     // the outputs' tile
  long long sb, sls, sss;     // the windows' source tile
  int n, sn;
  tile_geometry<AXIS>(a.n0, a.n1, a.n2, t, base, ls, ss, n);
  source_geometry<AXIS, HALO, W>(a.n0, a.n1, a.n2, t, sb, sls, sss, sn);
  const int k0 = HALO ? b * BS : b * BS - W;
  copy_window_async<BS, W, AXIS>(Cw, a.conv, sb, k0, sn, sls, sss);
  copy_window_async<BS, W, AXIS>(Qw, a.phi[0], sb, k0, sn, sls, sss);
  cp_async_wait();
  __syncthreads();

  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    const bool has_next = tn < ntiles;
    long long nbase = 0, nls = 0, nss = 0, nsb = 0, nsls = 0, nsss = 0;
    int nn = n, nsn = sn;
    if (has_next) {
      tile_geometry<AXIS>(a.n0, a.n1, a.n2, tn, nbase, nls, nss, nn);
      source_geometry<AXIS, HALO, W>(a.n0, a.n1, a.n2, tn, nsb, nsls, nsss,
                                     nsn);
    }

#pragma unroll 1
    for (int s = 0; s < a.nsp; ++s) {
      const bool last = s + 1 == a.nsp;
      // in flight while scalar s computes: the next scalar's window of
      // this tile, or after the last scalar the next tile's windows of the
      // first scalar and of the conv (their buffers were last read before
      // the previous barrier)
      if (!last) {
        copy_window_async<BS, W, AXIS>(Qn, a.phi[s + 1], sb, k0, sn, sls,
                                       sss);
      } else if (has_next) {
        copy_window_async<BS, W, AXIS>(Qn, a.phi[0], nsb, k0, nsn, nsls,
                                       nsss);
        copy_window_async<BS, W, AXIS>(Cn, a.conv, nsb, k0, nsn, nsls, nsss);
      }

      float dq[RPT][2], d2[RPT][2], dd[RPT][2];
      contract<BS, W, LDW>(Qw, Cw, SaT, DaT, tx, r0, dq, d2, dd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = tx + 32 * j;
        const long long row0 = base + (AXIS == 2 ? l * ls : (long long)l) +
                               (long long)(b * BS + r0) * ss;
        float av[RPT], res[RPT];
        if (ACC) load_rows<RPT, AXIS>(a.acc[s], row0, ss, av);
        line_rhs<RPT, W, ACC, LDW>(a.nu[s], j, l, r0, Cw, dq, d2, dd, av,
                                   res);
        store_rows<RPT, AXIS>(a.out[s], row0, ss, res);
      }

      cp_async_wait();
      __syncthreads();  // the next windows are complete, the current free
      float* q = Qw;
      Qw = Qn;
      Qn = q;
      if (last) {
        float* c = Cw;
        Cw = Cn;
        Cn = c;
      }
    }
    base = nbase;
    ls = nls;
    ss = nss;
    n = nn;
    sb = nsb;
    sls = nsls;
    sss = nsss;
    sn = nsn;
  }
}

template <int BS, int W, int AXIS, bool ACC, int NOLDS, bool UPD,
          bool BASE_SEP, int PREC = 0, bool HALO = false>
cudaError_t launch(const SweepArgs& a, long long ntiles, int nb, int grid_x,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BS, W, AXIS>();
  auto kern = transeq_sweep_kernel<BS, W, AXIS, ACC, NOLDS, UPD, BASE_SEP,
                                   PREC, HALO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid_x, nb), NT, smem, stream>>>(a, ntiles);
  return cudaGetLastError();
}

template <int BS, int W, int NOLDS, int PREC>
cudaError_t launch_xdiv(const SweepArgs& a, long long ntiles, int grid_x,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BS, W, 0>();
  auto kern = transeq_xdiv_kernel<BS, W, NOLDS, PREC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid_x, NT, smem, stream>>>(a, ntiles);
  return cudaGetLastError();
}

template <int BS, int W, int AXIS, bool ACC, bool HALO = false>
cudaError_t launch_species(const SpeciesArgs& a, long long ntiles, int nb,
                           int grid_x, cudaStream_t stream) {
  constexpr size_t smem = species_smem_bytes<BS, W, AXIS>();
  auto kern = species_sweep_kernel<BS, W, AXIS, ACC, HALO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(grid_x, nb), NT, smem, stream>>>(a, ntiles);
  return cudaGetLastError();
}

// The y sweep's AB update (1-3 history fields) at a reduced precision.
template <int BS, int W, int PREC>
cudaError_t launch_ab_y(int nolds, const SweepArgs& a, long long ntiles,
                        int nb, int grid_x, cudaStream_t s) {
  switch (nolds) {
    case 1: return launch<BS, W, 1, true, 1, true, false, PREC>(
        a, ntiles, nb, grid_x, s);
    case 2: return launch<BS, W, 1, true, 2, true, false, PREC>(
        a, ntiles, nb, grid_x, s);
    case 3: return launch<BS, W, 1, true, 3, true, false, PREC>(
        a, ntiles, nb, grid_x, s);
  }
  return cudaErrorInvalidValue;
}

// The reduced-precision instances (WITH_PREC): those of the fused AB
// chains, the partial sweeps with bfloat16 partials (z without, x and y
// with accumulate) and the y sweep's AB update with a bfloat16 history,
// partials or both.
template <int BS, int W, int AXIS, bool WITH_PREC>
cudaError_t dispatch_prec(int accumulate, int nolds, int upd, int base_sep,
                          int prec, const SweepArgs& a, long long ntiles,
                          int nb, int grid_x, cudaStream_t s) {
  if constexpr (WITH_PREC) {
    if (!upd) {
      if (prec != ACC_BF16 || nolds != 0 || base_sep)
        return cudaErrorInvalidValue;
      if constexpr (AXIS == 2) {
        if (!accumulate)
          return launch<BS, W, 2, false, 0, false, false, ACC_BF16>(
              a, ntiles, nb, grid_x, s);
      } else {
        if (accumulate)
          return launch<BS, W, AXIS, true, 0, false, false, ACC_BF16>(
              a, ntiles, nb, grid_x, s);
      }
      return cudaErrorInvalidValue;
    }
    if constexpr (AXIS == 1) {
      if (!accumulate || base_sep) return cudaErrorInvalidValue;
      switch (prec) {
        case OLDS_BF16:
          return launch_ab_y<BS, W, OLDS_BF16>(nolds, a, ntiles, nb, grid_x,
                                               s);
        case ACC_BF16:
          return launch_ab_y<BS, W, ACC_BF16>(nolds, a, ntiles, nb, grid_x,
                                              s);
        case OLDS_BF16 | ACC_BF16:
          return launch_ab_y<BS, W, OLDS_BF16 | ACC_BF16>(nolds, a, ntiles,
                                                          nb, grid_x, s);
      }
    }
  }
  return cudaErrorInvalidValue;
}

// The instances: every axis without an update and with the AB update (1-3
// history fields); the RK substage updates (no history and the sweep's own
// base; the step-initial base with 0, 2 or 3 stage derivatives, the RK1-4
// tableaus' rows) on the y sweep only, which ends the RK chain; with
// WITH_PREC the reduced-precision ones (dispatch_prec).
template <int BS, int W, int AXIS, bool WITH_PREC>
cudaError_t dispatch_axis(int accumulate, int nolds, int upd, int base_sep,
                          int prec, int halo, const SweepArgs& a,
                          long long ntiles, int nb, int grid_x,
                          cudaStream_t s) {
  if (halo) {
    // the halo form: the partial sweeps of the sharded axes (y, z)
    if (AXIS == 0 || upd || nolds != 0 || base_sep || prec != 0)
      return cudaErrorInvalidValue;
    if constexpr (AXIS != 0) {
      return accumulate
                 ? launch<BS, W, AXIS, true, 0, false, false, 0, true>(
                       a, ntiles, nb, grid_x, s)
                 : launch<BS, W, AXIS, false, 0, false, false, 0, true>(
                       a, ntiles, nb, grid_x, s);
    }
  }
  if (prec != 0)
    return dispatch_prec<BS, W, AXIS, WITH_PREC>(accumulate, nolds, upd,
                                                 base_sep, prec, a, ntiles,
                                                 nb, grid_x, s);
  if (!accumulate) {
    if (nolds != 0 || upd) return cudaErrorInvalidValue;
    return launch<BS, W, AXIS, false, 0, false, false>(a, ntiles, nb, grid_x,
                                                       s);
  }
  if (!upd) {
    if (nolds != 0 || base_sep) return cudaErrorInvalidValue;
    return launch<BS, W, AXIS, true, 0, false, false>(a, ntiles, nb, grid_x,
                                                      s);
  }
  if (!base_sep) {
    switch (nolds) {
      case 1: return launch<BS, W, AXIS, true, 1, true, false>(
          a, ntiles, nb, grid_x, s);
      case 2: return launch<BS, W, AXIS, true, 2, true, false>(
          a, ntiles, nb, grid_x, s);
      case 3: return launch<BS, W, AXIS, true, 3, true, false>(
          a, ntiles, nb, grid_x, s);
    }
  }
  if constexpr (AXIS == 1) {
    if (!base_sep && nolds == 0)
      return launch<BS, W, 1, true, 0, true, false>(a, ntiles, nb, grid_x, s);
    if (base_sep) {
      switch (nolds) {
        case 0: return launch<BS, W, 1, true, 0, true, true>(
            a, ntiles, nb, grid_x, s);
        case 2: return launch<BS, W, 1, true, 2, true, true>(
            a, ntiles, nb, grid_x, s);
        case 3: return launch<BS, W, 1, true, 3, true, true>(
            a, ntiles, nb, grid_x, s);
      }
    }
  }
  return cudaErrorInvalidValue;
}

// The xdiv instances: 1-3 history fields at each precision built.
template <int BS, int W, int PREC>
cudaError_t dispatch_xdiv(int nolds, const SweepArgs& a, long long ntiles,
                          int grid_x, cudaStream_t s) {
  switch (nolds) {
    case 1: return launch_xdiv<BS, W, 1, PREC>(a, ntiles, grid_x, s);
    case 2: return launch_xdiv<BS, W, 2, PREC>(a, ntiles, grid_x, s);
    case 3: return launch_xdiv<BS, W, 3, PREC>(a, ntiles, grid_x, s);
  }
  return cudaErrorInvalidValue;
}

template <int BS, int W, int AXIS>
cudaError_t dispatch_species(int accumulate, int halo, const SpeciesArgs& a,
                             long long ntiles, int nb, int grid_x,
                             cudaStream_t s) {
  if (halo) {
    // the halo form: the sharded axes (y, z)
    if constexpr (AXIS == 0) {
      return cudaErrorInvalidValue;
    } else {
      return accumulate ? launch_species<BS, W, AXIS, true, true>(
                              a, ntiles, nb, grid_x, s)
                        : launch_species<BS, W, AXIS, false, true>(
                              a, ntiles, nb, grid_x, s);
    }
  }
  return accumulate
             ? launch_species<BS, W, AXIS, true>(a, ntiles, nb, grid_x, s)
             : launch_species<BS, W, AXIS, false>(a, ntiles, nb, grid_x, s);
}

inline long long lines_of(int axis, int n0, int n1, int n2) {
  return axis == 0 ? (long long)n1 * n2
         : axis == 1 ? (long long)n0 * n2
                     : (long long)n0 * n1;
}

// ---------------------------------------------------------------------------
// The tensor-core momentum sweep (BS = 64, W = 16: transeq_sweep_tc_kernel)
// ---------------------------------------------------------------------------
// The function of transeq_sweep_kernel (every instance of the default
// mode's geometry but the halo form; the xdiv variant stays on its SIMT
// kernel) as split-TF32 wgmma products (see the head of the file). The
// contraction of one component over one line tile is, for each 16-row
// slice s of the output block (16 rows), D^T (64 lines x 48 rows) = F^T B
// over the slice's band: A = the field window (or q * conv) in registers,
// split to TF32 hi / lo there; B = the slice's operator rows in shared
// memory, K-major as they lie (x_apply_manual.cu's operand layout). A
// chunk is 16 window columns; slice s takes chunks s .. s + 2 (every row
// keeps its +/- W taps). On a uniform periodic axis the operators are
// circulant, so every slice of every output block has the same rows over
// its three chunks: three images a pairing serve the launch
// (ops/transeq_sweep.py tc_pack). The body takes no other operators: the
// wrapper sends an axis whose operators are not circulant to the SIMT
// body (tc_route). The three products (lo hi, hi lo, hi hi) of each k
// step of 8 are summed by the tensor cores into the slice's FP32
// accumulators over all 48 k of its band (six k steps), with no FP32 add
// a chunk.
namespace tc {

constexpr int TBS = 64;              // output rows a block
constexpr int TW = 16;               // band half-width
constexpr int TWIN = TBS + 2 * TW;   // window length, 96
constexpr int SL = 16;               // output rows a slice
constexpr int KC = 16;               // window columns a chunk
constexpr int SLICE_CHUNKS = 3;      // chunks a slice
constexpr int NTHR = 256;            // two warpgroups, two slices each
// an image (the slices' operator rows over their chunk j, one pairing):
// the [S1; S2] rows (32 x KC) hi then lo, then the D rows (16 x KC) hi
// then lo, each 64-byte swizzled (x_apply_manual.py block_index); images
// j = 0 .. 2 of the aligned pairing, then of the transverse one
constexpr int IMG = 2 * 2 * SL * KC + 2 * SL * KC;     // floats, 1536
constexpr int IMG_BYTES = IMG * 4;
constexpr int NIMG = SLICE_CHUNKS;
constexpr int OPS_BYTES = 2 * NIMG * IMG_BYTES;        // 36 KB
constexpr int S_HI = 0, S_LO = 2 * SL * KC * 4, D_HI = 2 * S_LO,
              D_LO = D_HI + SL * KC * 4;               // byte offsets
constexpr int WFLOATS = TWIN * TL;                     // a window
constexpr int STAGE_BYTES = 3 * WFLOATS * 4;           // u, v, w windows
constexpr int STAGES = 2;
constexpr int SMEM_ALIGN = 1024;
constexpr int SMEM_BYTES = SMEM_ALIGN + OPS_BYTES + STAGES * STAGE_BYTES;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");

struct TcSweepArgs {
  const float* f[3];                 // u, v, w
  const float* img;                  // (2 pairings, NIMG, IMG)
  const void* acc[3];                // float, or bfloat16 (acc_bf16)
  const void* old[3][3];             // old[j][c]; bfloat16 (olds_bf16)
  void* out[3];
  void* rhs[3];
  const float* base[3];              // base_sep
  int n0, n1, n2;
  float nu;
  float dtc[5];
  int accumulate, upd, olds_bf16, acc_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte asynchronous copy from device memory into shared memory
__device__ __forceinline__ void cp16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the operand of a k step's wgmma: N rows of an image part from shared
// address `addr`, K-major with the 64-byte swizzle (rows of 64 bytes,
// 8-row atoms 512 bytes apart); the next k step of 8 tf32 starts 32
// bytes, 2 units, on (x_apply_manual.cu's b_desc)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// x = hi + lo for the A operand: hi = RNA(x) to tf32 (cvt.rna, ties away
// from zero), lo = x - hi (exact), whose low 13 bits the tensor cores
// ignore, truncating it to tf32: |x - hi - tf32(lo)| < 2^-10 |lo| <=
// 2^-21 |x| (one cvt and one subtraction where a rounded lo takes two
// more instructions, and 2^-22)
__device__ __forceinline__ void split_a(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xFFFFE000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
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

// all but the newest commit group complete
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

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

// D (64 x 16) = D acc + A (64 x 8, tf32 registers) . B (8 x 16, shared)
__device__ __forceinline__ void mma_n16(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// D (64 x 32) = D acc + A (64 x 8, tf32 registers) . B (8 x 32, shared)
__device__ __forceinline__ void mma_n32(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t desc,
                                       int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Window element (column k, line l) in shared memory, swizzled so that the
// A fragment loads (8 lines x 4 columns a warp) meet 32 banks: z windows
// are line-major (96 columns a line, the 16-byte chunk c of line l at c ^
// (l & 7)); x and y windows column-major (64 lines a column, line l of
// column k at l ^ 8 (k & 3)). A 16-byte run (4 columns of a z line; 4
// lines of an x or y column) stays whole.
template <int AXIS>
__device__ __forceinline__ int widx(int k, int l) {
  if (AXIS == 2) return l * TWIN + ((((k >> 2) ^ (l & 7))) << 2) + (k & 3);
  return k * TL + (l ^ ((k & 3) << 3));
}

// The three windows of line tile t for output block b into a stage, by
// 16-byte asynchronous copies (consecutive threads on consecutive
// addresses; periodic along the sweep: n >= 96, one wrap suffices).
template <int AXIS>
__device__ __forceinline__ void issue_windows(const TcSweepArgs& a,
                                              uint32_t stage, long long t,
                                              int b) {
  long long base, ls, ss;
  int n;
  tile_geometry<AXIS>(a.n0, a.n1, a.n2, t, base, ls, ss, n);
  const int k0 = b * TBS - TW;
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const float* f = a.f[c] + base;
    const uint32_t dst = stage + c * WFLOATS * 4;
#pragma unroll
    for (int m = 0; m < WFLOATS / 4 / NTHR; ++m) {
      const int i = threadIdx.x + m * NTHR;
      int k, l;
      if (AXIS == 2) {
        l = i / (TWIN / 4);
        k = (i - l * (TWIN / 4)) * 4;
      } else {
        k = i / (TL / 4);
        l = (i - k * (TL / 4)) * 4;
      }
      int g = k0 + k;
      g = g < 0 ? g + n : (g >= n ? g - n : g);
      cp16(dst + widx<AXIS>(k, l) * 4,
           AXIS == 2 ? f + (long long)l * ls + g : f + (long long)g * ss + l);
    }
  }
}

// The A fragments of window chunk ch, split: q (the component) and p = q
// conv; a[st][i] holds (line 16 w + gid + 8 (i & 1), column 16 ch + 8 st +
// tig + 4 (i >> 1)), wgmma's tf32 A layout.
template <int AXIS>
__device__ __forceinline__ void load_a(const float* Q, const float* CV,
                                       int ch, int w, int gid, int tig,
                                       uint32_t (&qh)[2][4],
                                       uint32_t (&ql)[2][4],
                                       uint32_t (&ph)[2][4],
                                       uint32_t (&pl)[2][4]) {
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = widx<AXIS>(ch * KC + 8 * st + tig + 4 * (i >> 1),
                               16 * w + gid + 8 * (i & 1));
      const float q = Q[o], cvv = CV[o];
      split_a(q, qh[st][i], ql[st][i]);
      split_a(q * cvv, ph[st][i], pl[st][i]);
    }
}

// The epilogue's elements: e = 4 j + 2 ci + q is (line 16 w + gid + 8 ci,
// block row 16 s + 8 j + 2 tig + q), the wgmma accumulator's layout; the
// pairs (q = 0, 1) are neighbours along the sweep (contiguous along z).
template <int AXIS>
__device__ __forceinline__ float2 ld_pair(const void* p, bool bf,
                                          long long o, long long ss) {
  if (bf) {
    const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(p);
    if (AXIS == 2)
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(h + o));
    return make_float2(__bfloat162float(h[o]), __bfloat162float(h[o + ss]));
  }
  const float* f = static_cast<const float*>(p);
  if (AXIS == 2) return *reinterpret_cast<const float2*>(f + o);
  return make_float2(f[o], f[o + ss]);
}

template <int AXIS>
__device__ __forceinline__ void st_pair(void* p, bool bf, long long o,
                                        long long ss, float x, float y) {
  if (bf) {
    __nv_bfloat16* h = static_cast<__nv_bfloat16*>(p);
    if (AXIS == 2) {
      *reinterpret_cast<__nv_bfloat162*>(h + o) = __floats2bfloat162_rn(x, y);
    } else {
      h[o] = __float2bfloat16_rn(x);
      h[o + ss] = __float2bfloat16_rn(y);
    }
    return;
  }
  float* f = static_cast<float*>(p);
  if (AXIS == 2) {
    *reinterpret_cast<float2*>(f + o) = make_float2(x, y);
  } else {
    f[o] = x;
    f[o + ss] = y;
  }
}

template <int AXIS>
__device__ __forceinline__ void ld_elems(const void* p, bool bf,
                                         const long long (&o)[4],
                                         long long ss, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 x = ld_pair<AXIS>(p, bf, o[e / 2], ss);
    v[e] = x.x;
    v[e + 1] = x.y;
  }
}

// The epilogue of a slice: the output offset of each element pair e / 2
// (the q = 0 element), its streams (acc, the history, the base) loaded
// ahead of the combine, and the combine, accumulate, update and stores
// (see combine_line for the order of the update's terms).
template <int AXIS>
__device__ __forceinline__ void epi_offsets(int b, int s, int w, int gid,
                                            int tig, long long base,
                                            long long ls, long long ss,
                                            long long (&o)[4]) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int l = 16 * w + gid + 8 * ((e >> 1) & 1);
    const long long g = (long long)b * TBS + 16 * s + 8 * (e >> 2) + 2 * tig;
    o[e / 2] = base + (AXIS == 2 ? l * ls + g : l + g * ss);
  }
}

// a slice's streams: acc, NOLDS history fields, the base (BASE_SEP)
template <int NOLDS, bool BASE_SEP>
struct EpiIn {
  float av[8], ov[NOLDS > 0 ? NOLDS : 1][8], bv[BASE_SEP ? 8 : 1];
};

template <int AXIS, int NOLDS, bool BASE_SEP>
__device__ __forceinline__ void epi_load(const TcSweepArgs& a, int c,
                                         const long long (&o)[4],
                                         long long ss,
                                         EpiIn<NOLDS, BASE_SEP>& in) {
  if (a.accumulate) ld_elems<AXIS>(a.acc[c], a.acc_bf16, o, ss, in.av);
#pragma unroll
  for (int j = 0; j < NOLDS; ++j)
    ld_elems<AXIS>(a.old[j][c], a.olds_bf16, o, ss, in.ov[j]);
  if constexpr (BASE_SEP) ld_elems<AXIS>(a.base[c], false, o, ss, in.bv);
}

// r = -1/2 (conv D1 q + D1d (q conv)) + nu D2 q [+ acc]; with the update
// u' = base + dtc0 r + sum_j dtc_{j+1} old_j [+ dtc4 (r - bf16(r))]
template <int AXIS, int NOLDS, bool BASE_SEP>
__device__ __forceinline__ void epi_store(const TcSweepArgs& a, int c, int s,
                                          const float* Q, const float* CV,
                                          const float (&sd)[16],
                                          const float (&dd)[8],
                                          const EpiIn<NOLDS, BASE_SEP>& in,
                                          const long long (&o)[4],
                                          long long ss, int w, int gid,
                                          int tig) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int l = 16 * w + gid + 8 * ((e >> 1) & 1);
    const int kw = TW + 16 * s + 8 * (e >> 2) + 2 * tig;
    float r[2], un[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int x = widx<AXIS>(kw + q, l);
      r[q] = -0.5f * (CV[x] * sd[e + q] + dd[e + q]) + a.nu * sd[8 + e + q];
      if (a.accumulate) r[q] += in.av[e + q];
      if (a.upd) {
        if constexpr (BASE_SEP)
          un[q] = in.bv[e + q] + a.dtc[0] * r[q];
        else
          un[q] = Q[x] + a.dtc[0] * r[q];
#pragma unroll
        for (int j = 0; j < NOLDS; ++j) un[q] += a.dtc[j + 1] * in.ov[j][e + q];
        if (a.olds_bf16) {
          // pre-pay the stored rhs's rounding while r is exact
          const float rs = __bfloat162float(__float2bfloat16_rn(r[q]));
          un[q] += a.dtc[4] * (r[q] - rs);
        }
      }
    }
    if (a.upd) {
      st_pair<AXIS>(a.rhs[c], a.olds_bf16, o[e / 2], ss, r[0], r[1]);
      st_pair<AXIS>(a.out[c], false, o[e / 2], ss, un[0], un[1]);
    } else {
      st_pair<AXIS>(a.out[c], a.acc_bf16, o[e / 2], ss, r[0], r[1]);
    }
  }
}

// The A fragments of one chunk, split: q (the component) and p = q conv.
struct AFrag {
  uint32_t qh[2][4], ql[2][4], ph[2][4], pl[2][4];
};

__device__ __forceinline__ void fence_a(AFrag& f) {
  fence_reg(f.qh);
  fence_reg(f.ql);
  fence_reg(f.ph);
  fence_reg(f.pl);
}

// a slice's sums: [D1 q; D2 q] (n32) and D1d (q conv) (n16)
struct Part {
  float s[16], d[8];
};

// A chunk's three products (lo hi, hi lo, hi hi) of both k steps with the
// image at address `im`, added to P; acc = 0: the first replaces P.
__device__ __forceinline__ void issue_chunk(uint32_t im, const AFrag& f,
                                            Part& p, bool acc) {
  const uint64_t sh = b_desc(im + S_HI), sl = b_desc(im + S_LO);
  const uint64_t dh = b_desc(im + D_HI), dl = b_desc(im + D_LO);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int first = st > 0 || acc;
    mma_n32(p.s, f.ql[st], sh + 2 * st, first);
    mma_n32(p.s, f.qh[st], sl + 2 * st, 1);
    mma_n32(p.s, f.qh[st], sh + 2 * st, 1);
    mma_n16(p.d, f.pl[st], dh + 2 * st, first);
    mma_n16(p.d, f.ph[st], dl + 2 * st, 1);
    mma_n16(p.d, f.ph[st], dh + 2 * st, 1);
  }
}

// A warpgroup's work on one component of a tile: its two slices, a = 2 g
// and b = 2 g + 1, over the window chunks 2 g + t, t = 0 .. 3: chunk t is
// slice a's image t (t <= 2) and slice b's image t - 1 (t >= 1), so each
// chunk's fragments are loaded and split once for both slices. The run is
// unrolled: wgmma asks for control flow the compiler can prove uniform
// (with data-dependent trip counts around it, it serialises the wgmma).
// Chunk t's wgmma group goes to the tensor cores before chunk t - 1's is
// waited for (two sets of A fragments, used in turn); the tensor cores sum
// a slice over its three chunks (48 k, three products each) into its
// FP32 registers, and its epilogue runs once its last chunk is done, slice
// a's while chunk 3 computes. Both slices' streams are loaded as the
// component starts, ahead of the contraction.
template <int AXIS, int NOLDS, bool BASE_SEP>
__device__ __forceinline__ void component_items(
    const TcSweepArgs& a, int c, const float* F, uint32_t ops, int wg,
    long long base, long long ls, long long ss, int b, int w, int gid,
    int tig) {
  const float* Q = F + c * WFLOATS;
  const float* CV = F + AXIS * WFLOATS;
  const uint32_t im = ops + (c == AXIS ? 0 : NIMG * IMG_BYTES);
  const int s = 2 * wg;
  long long oa[4], ob[4];
  EpiIn<NOLDS, BASE_SEP> ia, ib;
  epi_offsets<AXIS>(b, s, w, gid, tig, base, ls, ss, oa);
  epi_load<AXIS>(a, c, oa, ss, ia);
  epi_offsets<AXIS>(b, s + 1, w, gid, tig, base, ls, ss, ob);
  epi_load<AXIS>(a, c, ob, ss, ib);
  AFrag f[2];
  Part pa, pb;   // the slices' sums
  load_a<AXIS>(Q, CV, s, w, gid, tig, f[0].qh, f[0].ql, f[0].ph, f[0].pl);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    // chunk t: slice a's image t, slice b's image t - 1 (the first product
    // of a slice replaces its sums)
    wgmma_fence();
    if (t < 3) issue_chunk(im + t * IMG_BYTES, f[t & 1], pa, t > 0);
    if (t > 0) issue_chunk(im + (t - 1) * IMG_BYTES, f[t & 1], pb, t > 1);
    wgmma_commit();
    if (t > 0) {
      wgmma_wait1();
      fence_a(f[(t - 1) & 1]);
    }
    if (t == 3) {
      // chunk 2 is done: slice a is complete
      fence_acc(pa.s);
      fence_acc(pa.d);
      epi_store<AXIS>(a, c, s, Q, CV, pa.s, pa.d, ia, oa, ss, w, gid, tig);
    }
    if (t < 3) {
      load_a<AXIS>(Q, CV, s + t + 1, w, gid, tig, f[(t + 1) & 1].qh,
                   f[(t + 1) & 1].ql, f[(t + 1) & 1].ph, f[(t + 1) & 1].pl);
    }
  }
  wgmma_wait();
  fence_a(f[1]);
  fence_acc(pb.s);
  fence_acc(pb.d);
  epi_store<AXIS>(a, c, s + 1, Q, CV, pb.s, pb.d, ib, ob, ss, w, gid, tig);
}

// Grid (blocks per output block, output blocks); a block stages the images
// (one set: every output block's slices have the same operators) and walks
// line tiles t = blockIdx.x, + gridDim.x, ... of output block b; warpgroup
// g takes slices 2 g and 2 g + 1 of every component. The next tile's
// windows are in flight (cp.async, one group a tile) while a tile
// computes.
template <int AXIS, int NOLDS, bool BASE_SEP>
__global__ void __launch_bounds__(NTHR, 1)
transeq_sweep_tc_kernel(const __grid_constant__ TcSweepArgs a,
                        long long ntiles) {
  extern __shared__ unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t pad = ((raw + SMEM_ALIGN - 1) & ~(SMEM_ALIGN - 1)) - raw;
  unsigned char* base_p = tc_smem + pad;
  const uint32_t ops = raw + pad;
  const uint32_t win = ops + OPS_BYTES;
  const float* winp = reinterpret_cast<const float*>(base_p + OPS_BYTES);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  {
    const float4* src = reinterpret_cast<const float4*>(a.img);
    float4* dst = reinterpret_cast<float4*>(base_p);
    for (int i = tid; i < OPS_BYTES / 16; i += NTHR) dst[i] = __ldg(src + i);
  }
  // the images were written by the generic proxy; wgmma reads them by the
  // async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int wg = tid >> 7, w = (tid >> 5) & 3;
  const int gid = (tid & 31) >> 2, tig = tid & 3;
  long long t = blockIdx.x;
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    const long long tt = t + (long long)st * gridDim.x;
    if (tt < ntiles) issue_windows<AXIS>(a, win + st * STAGE_BYTES, tt, b);
    cp_commit();
  }
#pragma unroll 1
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    // this tile's group is complete once at most STAGES - 1 are pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncthreads();
    const int stg = it % STAGES;
    const float* F = winp + stg * 3 * WFLOATS;
    long long base, ls, ss;
    int n;
    tile_geometry<AXIS>(a.n0, a.n1, a.n2, t, base, ls, ss, n);
#pragma unroll 1
    for (int c = 0; c < 3; ++c)
      component_items<AXIS, NOLDS, BASE_SEP>(a, c, F, ops, wg, base, ls, ss,
                                             b, w, gid, tig);
    __syncthreads();  // every thread is done with this stage
    const long long tn = t + (long long)STAGES * gridDim.x;
    if (tn < ntiles) issue_windows<AXIS>(a, win + stg * STAGE_BYTES, tn, b);
    cp_commit();
  }
}

constexpr int MAX_DEV = 16;   // devices whose attribute is remembered

// an instance's shared-memory attribute is set once a device (past
// MAX_DEV devices, at every launch)
template <int AXIS, int NOLDS, bool BASE_SEP>
cudaError_t launch_axis(const TcSweepArgs& a, long long ntiles, int nb,
                        int grid_x, cudaStream_t s) {
  static std::atomic<bool> ready[MAX_DEV];
  auto kern = transeq_sweep_tc_kernel<AXIS, NOLDS, BASE_SEP>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEV || !ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEV) ready[dev].store(true, std::memory_order_release);
  }
  kern<<<dim3(grid_x, nb), NTHR, SMEM_BYTES, s>>>(a, ntiles);
  return cudaGetLastError();
}

// the instances: every axis with 0-3 history fields and the sweep's own
// base; the y sweep (which ends the RK chain) also with the step-initial
// base and 0, 2 or 3 stage derivatives
template <int AXIS>
cudaError_t dispatch(int nolds, int base_sep, const TcSweepArgs& a,
                     long long ntiles, int nb, int grid_x, cudaStream_t s) {
  if (!base_sep) {
    switch (nolds) {
      case 0: return launch_axis<AXIS, 0, false>(a, ntiles, nb, grid_x, s);
      case 1: return launch_axis<AXIS, 1, false>(a, ntiles, nb, grid_x, s);
      case 2: return launch_axis<AXIS, 2, false>(a, ntiles, nb, grid_x, s);
      case 3: return launch_axis<AXIS, 3, false>(a, ntiles, nb, grid_x, s);
    }
  } else if constexpr (AXIS == 1) {
    switch (nolds) {
      case 0: return launch_axis<1, 0, true>(a, ntiles, nb, grid_x, s);
      case 2: return launch_axis<1, 2, true>(a, ntiles, nb, grid_x, s);
      case 3: return launch_axis<1, 3, true>(a, ntiles, nb, grid_x, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace tc

// The tensor-core sweep's C interface body: as sweep_launch's momentum
// sweeps, with the operators as packed images (tc_pack).
inline int sweep_tc_launch(int axis, int accumulate, int nolds, int upd,
                           int base_sep, int prec, void* const* ptrs, int n0,
                           int n1, int n2, float nu, const float* dtc,
                           int grid_x, void* stream) {
  const int n = axis == 0 ? n0 : (axis == 1 ? n1 : n2);
  if (axis < 0 || axis > 2 || nolds < 0 || nolds > 3 || (upd && !accumulate)
      || (!upd && (nolds || base_sep)) || prec < 0 || prec > 3
      || ((prec & OLDS_BF16) && (!upd || !nolds || base_sep))
      || n % tc::TBS || n < tc::TWIN || n2 % TL || ((long long)n0 * n1) % TL
      || grid_x < 1)
    return cudaErrorInvalidValue;
  tc::TcSweepArgs a;
  int i = 0;
  for (int c = 0; c < 3; ++c) a.f[c] = static_cast<const float*>(ptrs[i++]);
  a.img = static_cast<const float*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.acc[c] = ptrs[i++];
  for (int j = 0; j < 3; ++j)
    for (int c = 0; c < 3; ++c) a.old[j][c] = ptrs[i++];
  for (int c = 0; c < 3; ++c) a.out[c] = ptrs[i++];
  for (int c = 0; c < 3; ++c) a.rhs[c] = ptrs[i++];
  for (int c = 0; c < 3; ++c) a.base[c] = static_cast<const float*>(ptrs[i++]);
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.nu = nu;
  for (int j = 0; j < 5; ++j) a.dtc[j] = dtc[j];
  a.accumulate = accumulate;
  a.upd = upd;
  a.olds_bf16 = (prec & OLDS_BF16) != 0;
  a.acc_bf16 = (prec & ACC_BF16) != 0;
  const int nb = n / tc::TBS;
  const long long ntiles = lines_of(axis, n0, n1, n2) / TL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (axis) {
    case 0: return tc::dispatch<0>(nolds, base_sep, a, ntiles, nb, grid_x, s);
    case 1: return tc::dispatch<1>(nolds, base_sep, a, ntiles, nb, grid_x, s);
    case 2: return tc::dispatch<2>(nolds, base_sep, a, ntiles, nb, grid_x, s);
  }
  return cudaErrorInvalidValue;
}

// Compile-time geometry of the tensor-core sweep, for the wrapper's
// packing and checks: output rows a block, band, rows a slice, columns a
// chunk, threads, floats of an image, images a pairing, bytes of a window
// stage, window stages, the launch's dynamic shared memory.
inline int sweep_tc_geometry(int* g) {
  g[0] = tc::TBS;
  g[1] = tc::TW;
  g[2] = tc::SL;
  g[3] = tc::KC;
  g[4] = tc::NTHR;
  g[5] = tc::IMG;
  g[6] = tc::NIMG;
  g[7] = tc::STAGE_BYTES;
  g[8] = tc::STAGES;
  g[9] = tc::SMEM_BYTES;
  return 0;
}

// The bodies of the C interface (each translation unit exports them for
// its geometry; see transeq_sweep.cu).
template <int BS, int W>
int geometry(int* bs, int* w, int* tl, int* xdiv_max_nb, int* max_species) {
  *bs = BS;
  *w = W;
  *tl = TL;
  *xdiv_max_nb = Geo<BS, W>::XDIV_NP;
  *max_species = MAX_SPECIES;
  return 0;
}

template <int BS, int W, bool WITH_PREC>
int sweep_launch(int axis, int accumulate, int nolds, int upd, int base_sep,
                 int xdiv, int prec, int halo, void* const* ptrs, int n0,
                 int n1, int n2, float nu, const float* dtc, int grid_x,
                 void* stream) {
  SweepArgs a;
  int i = 0;
  for (int c = 0; c < 3; ++c) a.f[c] = static_cast<const float*>(ptrs[i++]);
  a.sa = static_cast<const float*>(ptrs[i++]);
  a.st = static_cast<const float*>(ptrs[i++]);
  a.da = static_cast<const float*>(ptrs[i++]);
  a.dt = static_cast<const float*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.acc[c] = ptrs[i++];
  for (int j = 0; j < 3; ++j)
    for (int c = 0; c < 3; ++c) a.old[j][c] = ptrs[i++];
  for (int c = 0; c < 3; ++c) a.out[c] = ptrs[i++];
  for (int c = 0; c < 3; ++c) a.rhs[c] = ptrs[i++];
  for (int j = 0; j < 2; ++j) a.xm[j] = static_cast<const float*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.div[c] = static_cast<float*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.base[c] = static_cast<const float*>(ptrs[i++]);
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.nu = nu;
  for (int j = 0; j < 5; ++j) a.dtc[j] = dtc[j];

  const int n = axis == 0 ? n0 : (axis == 1 ? n1 : n2);
  const int nb = n / BS;
  const long long ntiles = lines_of(axis, n0, n1, n2) / TL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdiv) {
    if (axis != 0 || !accumulate || !upd || base_sep || halo ||
        n > XDIV_MAX_N)
      return cudaErrorInvalidValue;
    if (prec == 0) return dispatch_xdiv<BS, W, 0>(nolds, a, ntiles, grid_x, s);
    if constexpr (WITH_PREC) {
      switch (prec) {
        case OLDS_BF16:
          return dispatch_xdiv<BS, W, OLDS_BF16>(nolds, a, ntiles, grid_x, s);
        case ACC_BF16:
          return dispatch_xdiv<BS, W, ACC_BF16>(nolds, a, ntiles, grid_x, s);
        case OLDS_BF16 | ACC_BF16:
          return dispatch_xdiv<BS, W, OLDS_BF16 | ACC_BF16>(nolds, a, ntiles,
                                                            grid_x, s);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (axis) {
    case 0: return dispatch_axis<BS, W, 0, WITH_PREC>(
        accumulate, nolds, upd, base_sep, prec, halo, a, ntiles, nb, grid_x,
        s);
    case 1: return dispatch_axis<BS, W, 1, WITH_PREC>(
        accumulate, nolds, upd, base_sep, prec, halo, a, ntiles, nb, grid_x,
        s);
    case 2: return dispatch_axis<BS, W, 2, WITH_PREC>(
        accumulate, nolds, upd, base_sep, prec, halo, a, ntiles, nb, grid_x,
        s);
  }
  return cudaErrorInvalidValue;
}

template <int BS, int W>
int species_launch(int axis, int accumulate, int halo, int nsp,
                   void* const* ptrs, int n0, int n1, int n2,
                   const float* nus, int grid_x, void* stream) {
  if (nsp < 1 || nsp > MAX_SPECIES) return cudaErrorInvalidValue;
  SpeciesArgs a;
  int i = 0;
  a.conv = static_cast<const float*>(ptrs[i++]);
  a.sa = static_cast<const float*>(ptrs[i++]);
  a.da = static_cast<const float*>(ptrs[i++]);
  for (int q = 0; q < MAX_SPECIES; ++q)
    a.phi[q] = static_cast<const float*>(ptrs[i++]);
  for (int q = 0; q < MAX_SPECIES; ++q)
    a.acc[q] = static_cast<const float*>(ptrs[i++]);
  for (int q = 0; q < MAX_SPECIES; ++q)
    a.out[q] = static_cast<float*>(ptrs[i++]);
  for (int q = 0; q < MAX_SPECIES; ++q) a.nu[q] = q < nsp ? nus[q] : 0.f;
  a.nsp = nsp;
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;

  const int n = axis == 0 ? n0 : (axis == 1 ? n1 : n2);
  const int nb = n / BS;
  const long long ntiles = lines_of(axis, n0, n1, n2) / TL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (axis) {
    case 0: return dispatch_species<BS, W, 0>(accumulate, halo, a,
                                              ntiles, nb, grid_x, s);
    case 1: return dispatch_species<BS, W, 1>(accumulate, halo, a,
                                              ntiles, nb, grid_x, s);
    case 2: return dispatch_species<BS, W, 2>(accumulate, halo, a,
                                              ntiles, nb, grid_x, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace sweep

// The C interface of one geometry: ptrs of transeq_sweep_launch are u, v,
// w (with halo the extended operands, n + 2W along the sweep axis, and sa
// ... dt the global stacks from the shard's first block), sa, st, da, dt, acc[3], old[j][c] (9, j-major), out[3], rhs[3], for
// xdiv the Sx and Ix slices and du, dv, dw, then for base_sep the base
// fields; unused entries may be null. prec: the PREC flags (OLDS_BF16 = 1,
// ACC_BF16 = 2). dtc: 5 floats (the 5th: the error feedback of a bfloat16
// history). grid_x: blocks per x block, or with xdiv blocks in all.
// species_sweep_launch: nsp (1..MAX_SPECIES) scalars; ptrs conv, sa, da,
// phi[MAX_SPECIES], acc[MAX_SPECIES], out[MAX_SPECIES], entries past nsp
// (and acc without accumulate) may be null; nus: nsp floats; grid_x:
// blocks per output block. halo: the halo form (axes 1 and 2, no update);
// n0, n1, n2 are the shard's extents. Each returns the cudaError_t of the
// launch (0 on success).
#define TRANSEQ_SWEEP_C_INTERFACE(BS, W, WITH_PREC)                           \
  extern "C" {                                                                \
  int transeq_sweep_geometry(int* bs, int* w, int* tl, int* xdiv_max_nb,      \
                             int* max_species) {                              \
    return sweep::geometry<BS, W>(bs, w, tl, xdiv_max_nb, max_species);       \
  }                                                                           \
  int transeq_sweep_launch(int axis, int accumulate, int nolds, int upd,      \
                           int base_sep, int xdiv, int prec, int halo,        \
                           void* const* ptrs, int n0, int n1, int n2,         \
                           float nu, const float* dtc, int grid_x,            \
                           void* stream) {                                    \
    return sweep::sweep_launch<BS, W, WITH_PREC>(                             \
        axis, accumulate, nolds, upd, base_sep, xdiv, prec, halo, ptrs, n0,   \
        n1, n2, nu, dtc, grid_x, stream);                                     \
  }                                                                           \
  int species_sweep_launch(int axis, int accumulate, int halo, int nsp,       \
                           void* const* ptrs, int n0, int n1, int n2,         \
                           const float* nus, int grid_x, void* stream) {      \
    return sweep::species_launch<BS, W>(axis, accumulate, halo, nsp, ptrs,    \
                                        n0, n1, n2, nus, grid_x, stream);     \
  }                                                                           \
  const char* transeq_sweep_error_string(int err) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }                                                                           \
  }

// The tensor-core sweep's C interface (the default mode's geometry; its
// library is transeq_sweep_tc.cu): transeq_sweep_tc_launch's ptrs are u, v, w, the packed images, acc[3],
// old[j][c] (9, j-major), out[3], rhs[3], base[3] (unused entries may be
// null); prec, dtc as transeq_sweep_launch's; grid_x: blocks per output
// block. Returns the cudaError_t of the launch.
#define TRANSEQ_SWEEP_TC_C_INTERFACE()                                        \
  extern "C" {                                                                \
  int transeq_sweep_tc_geometry(int* g) {                                     \
    return sweep::sweep_tc_geometry(g);                                       \
  }                                                                           \
  int transeq_sweep_tc_launch(int axis, int accumulate, int nolds, int upd,   \
                              int base_sep, int prec, void* const* ptrs,      \
                              int n0, int n1, int n2, float nu,               \
                              const float* dtc, int grid_x, void* stream) {   \
    return sweep::sweep_tc_launch(axis, accumulate, nolds, upd, base_sep,     \
                                  prec, ptrs, n0, n1, n2, nu, dtc, grid_x,    \
                                  stream);                                    \
  }                                                                           \
  const char* transeq_sweep_error_string(int err) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }                                                                           \
  }
