// The slab projection as batched operator applies, for Hopper (sm_90a),
// behind a plain C interface.
//
// x3d2_tpu's projection pipeline (make_pressure_pipe3,
// x3d2_tpu/ops/pallas_poisson.py:1573) is the split-TF32 tensor-core
// kernel of x_apply_manual.cu: its stages A, B and C (_pipe_a_kernel
// :1378, _pipe_b_kernel :1405, _pipe_c_kernel :1455). Stage C with the
// carry (X3D2_D2C=1, :1523-1552) takes two launches here (the inverse y
// transforms, the banded y) before pipe_c_d2.cu's.
// Each function is a few launches of one kernel template that applies an
// operator matrix along one axis of a field, out = M . f, in one of three
// forms (the forms of the TPU kernels):
//   BANDED  block-banded M: output block b of 64 rows reads the window of
//           64 + 2*BW rows starting at 64*b - BW (periodic wrap); the y
//           interpolation and staggered derivative of the mid and of
//           stage C with the carry.
//   PFWD    forward parity split of a transform-folded M:
//           [E; O] = [Me (f1 + f2); Mo (f1 - f2)], f1, f2 the halves of f
//           (one radix-2 level in matrix form: half the operations).
//   PINV    inverse parity split: [a + b; a - b], a = Me f_e, b = Mo f_o.
// The contraction runs along the slow axis of a row-major slab (x, or y
// batched over x-planes) or, transposed, along the contiguous z axis. A
// launch takes up to 3 jobs (fields) and a job up to 2 sources summed into
// one result (Iz . + Sz .), each source in a chain of its own, the two
// sums added as the plain version adds them. Epilogues: store, subtract
// from a field (the velocity correction), or the spectral solve after a y
// or a z apply (multiply by -1/waves rebuilt from separable tables, with
// the zero-wave guard, and by the Nyquist mask 1 - mx * Myz where the
// Poisson variant zeros a line).
//
// The same template carries the slab projection (make_pressure_slab,
// pallas_poisson.py:553; wrappers in ops/pressure_slab.py):
//   - _x_parity_fwd3_kernel      pallas_poisson.py:1067  one PFWD launch
//     along x with three jobs: du = Sx u, dv = Ix v, dw = Ix w
//   - _pressure_mid_kernel       pallas_poisson.py:354   six launches:
//     banded y (Iy du + Sy dv; Iy dw), PFWD z (Iz . + Sz .), PFWD y with
//     the solve in its epilogue (the x mode is the plane of the batch:
//     SOLVE_PLANE), PINV z (Gzi q, Gzs q), PINV y, banded y (Giy, Gsy, Giy)
//   - _x_parity_gradsub3_kernel  pallas_poisson.py:1106  one PINV launch
//     along x with three jobs and the subtracting epilogue
//   (the dense x stage, _x_apply_kernel pallas_poisson.py:954, is the
//   split-TF32 tensor-core kernel of x_apply_manual.cu, not a form of
//   this template)
//   - the dense forms of _pressure_mid_kernel (X3D2_BFLY=0; the dense-Ty
//     and dense-z branches of _div_solve_body / _grad_body,
//     pallas_poisson.py:189-310, which _div_solve_kernel :327 and
//     _grad_kernel :340 share): the mid's six launches with DENSE in
//     place of PFWD and PINV, along y batched over x planes (the forward
//     Ty with the SOLVE_PLANE epilogue, the inverse Ty) and, transposed,
//     along the contiguous z axis (Iz . + Sz ., Gzi q and Gzs q). They do
//     twice the operations of the parity forms.
//   - the folded y of _div_solve_body / _grad_body (pallas_poisson.py:
//     238-241, :307-310: a periodic y not a multiple of 64, where x3d2_tpu
//     has no banded y): four launches, DENSE y with two sources (Iy du +
//     Sy dv; Iy dw, the transform-folded (ncy, nvy) operators), the z
//     transforms with the solve in their epilogue (TRANS SOLVE), the
//     inverse z transforms, DENSE y with three jobs (gy_i, gy_s, gy_i).
//
// One kernel body with two kinds of instances (mat_apply_kernel<..., TAIL>):
// the 128-tiled ones (TAIL = false: every extent a multiple of the tiles,
// rows, columns, parity halves of 64) and the general ones (TAIL = true:
// every extent x3d2_tpu's gates admit, an x of 144 or 320, a y of 192 or
// 200, x y columns not a multiple of 128, and the forms the tiled ones
// lack, TRANS SOLVE, DENSE y with two sources or a rectangular operator).
// The general instances' guards are compiled out of the tiled ones, and the
// launcher (ops/operator_apply.py geometry) takes a tiled instance wherever
// it tiles the launch, so results, registers and times on those grids are
// as they were before the tails (tools/template_bits.py checks that).

// Bound on an H100 at 512^3: the mid with q needs about 8.8 ms at the 67
// TFLOP/s FP32 rate (the dense parity halves dominate; the banded applies
// count their 2*BW + 1 band taps; chip_smoke.py slab_cost), against 7 field
// passes of device memory (about 1.1 ms at 3.35 TB/s) for the function
// itself: bound by operations.
// What the design does about it: a classic register-tiled FP32 product,
// 128 x 128 outputs per block of 256 threads, 8 x 8 per thread, two blocks
// per SM, operands double-buffered through shared memory in k-steps of 8
// with the next step's global loads issued before the current step's FMAs
// (one barrier per k-step). The parity combine
// (f1 +/- f2) and the band window are applied while staging the operand,
// and the solve and the correction in the epilogue, so no extra pass over
// a field is made for them. Unlike the TPU kernels, which hold a whole
// (ny, nz) plane or x-column in VMEM, a stage here writes its
// intermediates (p, z, q, GH) to device memory: a 512 x 512 plane is
// 1 MB, beyond the 227 KB of shared memory of one block.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output rows per block: two groups of GR
constexpr int GR = 64;    // rows per group (and the banded block size)
constexpr int BN = 128;   // output columns per block
constexpr int BK = 8;     // k-step
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // shared-memory row pad (keeps float4 alignment)
// dynamic shared memory of a two-source launch: the stash of the block's
// 128 x 128 sums of its first source
constexpr int STASH_BYTES = BM * BN * 4;

enum { BANDED = 0, PFWD = 1, PINV = 2, DENSE = 3 };
enum { STORE = 0, SUB = 1, SOLVE = 2, SOLVE_PLANE = 3 };

struct Job {
  const float* A[2];   // operator matrices (rows x K, row-major), per source
  const float* B[2];   // field operands, per source
  float* C;            // result
  const float* S;      // SUB: the field the result is subtracted from
  int nsrc;
};

struct Args {
  Job job[3];
  int batch;           // planes per job: blockIdx.z = job * batch + plane
  int K;               // contraction length of one source
  int nrow;            // field rows along the contracted axis
  int nout;            // DENSE: output rows (the operator's rows)
  int h;               // nrow / 2 (PFWD: input half; PINV: output half)
  int bw;              // BANDED: band half-width
  long long ld;        // stride of a row (TRANS: of a column)
  long long pstride;   // stride between the planes of a batch
  // SOLVE (after a z apply, TRANS): A, B per (y, z) mode, k2x, tx2 per x
  // mode (the column's plane). SOLVE_PLANE (after a y apply batched over
  // x planes): A, B per (output row, column), k2x, tx2 per plane. tab[2],
  // col[2]: the Nyquist indicators Myz and mx, laid out as A and k2x; null
  // without a mask.
  const float* tab[3];
  const float* col[3];
  // the general instance's: the output's row (TRANS: column) and plane
  // strides, the columns, and the columns of one x plane (TRANS SOLVE)
  long long ldo;
  long long pstrideo;
  long long ncols;
  int cpp;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 axpy4(float4 x, float s, float4 y) {
  return make_float4(x.x + s * y.x, x.y + s * y.y, x.z + s * y.z,
                     x.w + s * y.w);
}

// One kernel body, two kinds of instances. TAIL = false, the 128-tiled
// instances: every extent a multiple of the tiles (rows, columns, parity
// halves of 64), TWO chosen at compile time. TAIL = true, the general
// instances: every extent x3d2_tpu's gates admit, and the forms the tiled
// ones lack; they compute what the tiled ones compute, with the same k-order
// of their multiply-adds (so on a grid both serve they give the same bits),
// and guard what the tiled ones take for granted, under `if (TAIL)`:
//   - output rows in tails: BANDED blocks of GR rows (y a multiple of 64);
//     PFWD and PINV in halves of any length ho = nout / 2, a block taking
//     GR rows of each half (group 0 the even-mode half, group 1 the odd),
//     so a half need not be a multiple of GR; DENSE any nout. Rows past
//     a group's end (nv) are neither loaded nor stored.
//   - any contraction length K: the operator read a float4 a load where K
//     is a multiple of 4, else one float, the operand's k past K read as
//     zeros;
//   - columns past ncols (TRANS: nx * ny a multiple of 4, not of 128);
//   - rectangular DENSE operators along y and z: the output has its own
//     row (TRANS: column) stride ldo and plane stride pstrideo;
//   - the solve after the z apply (TRANS SOLVE: the folded y branch of
//     the mid, where the z stage is the last before the solve): the x
//     mode is column / cpp, the table entry (column % cpp) * ldo + row.
// A general instance takes two-source jobs at run time (nsrc == 2).
template <int MODE, bool TRANS, int EPI, bool TWO, bool TAIL>
__global__ void __launch_bounds__(NT, 2)
mat_apply_kernel(const __grid_constant__ Args a) {
  // two stages of operands: the next k-step is staged while the current
  // one is read, so one barrier per k-step suffices
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][2][BK][BN + PAD];
  extern __shared__ float4 stash4[];   // two sources: STASH_BYTES

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const Job& J = a.job[blockIdx.z / a.batch];
  const long long base = (long long)(blockIdx.z % a.batch) * a.pstride;
  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y;
  const int ho = a.nout / 2;   // TAIL PFWD, PINV: rows of an output half

  // first operator row of each 64-row group; first field row of each
  // group's operand at k = 0; PFWD sign of each group's half; TAIL: the
  // group's rows in range
  int arow[2], brow[2], nv[2];
  float sg[2] = {1.f, 1.f};
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (MODE == DENSE) {
      arow[g] = mt * BM + g * GR;
      brow[g] = 0;
    } else if (MODE == PINV) {
      arow[g] = g * (TAIL ? ho : a.h) + mt * GR;
      brow[g] = g * a.h;
    } else if (TAIL && MODE == PFWD) {
      arow[g] = g * ho + mt * GR;
      brow[g] = 0;
    } else {
      arow[g] = mt * BM + g * GR;
      brow[g] = 0;
    }
    if (MODE == BANDED) brow[g] = (arow[g] - a.bw + a.nrow) % a.nrow;
    if (MODE == PFWD) sg[g] = (TAIL ? g == 0 : arow[g] < a.h) ? 1.f : -1.f;
    if (TAIL) {
      const int lim = MODE == PFWD || MODE == PINV ? ho - mt * GR
                      : (MODE == BANDED ? a.nrow : a.nout) - arow[g];
      nv[g] = lim < 0 ? 0 : (lim > GR ? GR : lim);
    }
  }

  // staging assignment: A as (row tid/2, k 4*(tid&1)); B as
  // (k tid/32, col 4*(tid&31)), or transposed (col tid/2, k 4*(tid&1))
  const int am = tid >> 1;
  const int ak = (tid & 1) * 4;
  const int bk = TRANS ? (tid & 1) * 4 : tid >> 5;
  const int bn = TRANS ? tid >> 1 : (tid & 31) * 4;
  const int ktiles = (a.K + BK - 1) / BK;   // DENSE, TAIL: K may be ragged
  const int ntiles = J.nsrc * ktiles;
  // TAIL: the thread's staging column in range; whole float4 loads of the
  // operator's rows where K is a multiple of 4, and (TRANS) of the
  // operand's k where its rows are aligned
  const bool colok = !TAIL || n0 + bn < a.ncols;
  const bool vec_op = (a.K & 3) == 0;
  const bool vec_in = (a.ld & 3) == 0 && vec_op;

  float4 ra, rb[2];
  auto fetch = [&](int t) {
    const int s = t / ktiles;
    const int kt = (t - s * ktiles) * BK;
    const int ar = (am < GR ? arow[0] : arow[1]) + (am & (GR - 1));
    const float* B = J.B[s] + base;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE == DENSE || TAIL) {
      // rows out of range and k past K read as zeros (DENSE: the
      // operator's rows are K long, no float4 alignment)
      const bool rok = TAIL ? (am & (GR - 1)) < (am < GR ? nv[0] : nv[1])
                            : ar < a.nout;
      if (TAIL && vec_op) {
        // K a multiple of 4: the row's float4 of k is whole or past K
        ra = (rok && kt + ak < a.K) ? ld4(J.A[s] + (long long)ar * a.K
                                          + kt + ak)
                                    : zero;
      } else {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = kt + ak + i;
          v[i] = (rok && k < a.K)
                     ? __ldg(J.A[s] + (long long)ar * a.K + k) : 0.f;
        }
        ra = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      ra = ld4(J.A[s] + (long long)ar * a.K + kt + ak);
    }
    if (TAIL && TRANS && !vec_in) {
      // unaligned rows: one float a load, each k guarded
      float w[2][4] = {};
#pragma unroll
      for (int g = 0; g < (MODE == DENSE ? 1 : 2); ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = kt + bk + i;
          const int row = MODE == PINV ? brow[g] + k
                          : MODE == PFWD ? g * a.K + k : k;
          w[g][i] = (colok && k < a.K)
                        ? __ldg(B + (long long)(n0 + bn) * a.ld + row) : 0.f;
        }
      rb[0] = make_float4(w[0][0], w[0][1], w[0][2], w[0][3]);
      rb[1] = MODE == DENSE ? rb[0]
                            : make_float4(w[1][0], w[1][1], w[1][2], w[1][3]);
      return;
    }
    if (TAIL && (!colok || kt + bk >= a.K)) {
      rb[0] = rb[1] = zero;
      return;
    }
    if (MODE == DENSE) {
      // the field has K rows (TRANS: K a multiple of 8, or a multiple of
      // 4 in the general instance, so a float4 of k is whole or past K)
      const int r = kt + bk;
      const long long off = TRANS ? (long long)(n0 + bn) * a.ld + r
                                  : (long long)r * a.ld + n0 + bn;
      rb[0] = r < a.K ? ld4(B + off) : zero;
      rb[1] = rb[0];   // both row groups read the same operand rows
      return;
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (MODE == PFWD && g == 1) break;
      int r = brow[g] + kt + bk;
      if (MODE == BANDED && r >= a.nrow) r -= a.nrow;
      const long long off = TRANS ? (long long)(n0 + bn) * a.ld + r
                                  : (long long)r * a.ld + n0 + bn;
      rb[g] = ld4(B + off);
      if (MODE == PFWD) {
        const long long off2 = TRANS ? off + a.h : off + (long long)a.h * a.ld;
        rb[1] = ld4(B + off2);
      }
    }
  };
  auto stage = [&](int buf) {
    As[buf][ak + 0][am] = ra.x;
    As[buf][ak + 1][am] = ra.y;
    As[buf][ak + 2][am] = ra.z;
    As[buf][ak + 3][am] = ra.w;
    float4 v[2];
    if (MODE == PFWD) {
      v[0] = axpy4(rb[0], sg[0], rb[1]);
      v[1] = axpy4(rb[0], sg[1], rb[1]);
    } else {
      v[0] = rb[0];
      v[1] = rb[1];
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (TRANS) {
        Bs[buf][g][bk + 0][bn] = v[g].x;
        Bs[buf][g][bk + 1][bn] = v[g].y;
        Bs[buf][g][bk + 2][bn] = v[g].z;
        Bs[buf][g][bk + 3][bn] = v[g].w;
      } else {
        *reinterpret_cast<float4*>(&Bs[buf][g][bk][bn]) = v[g];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // A two-source job sums each source in a chain of its own and adds the
  // two sums, as the plain version adds its two products: the first
  // source's sums wait in shared memory, 64 floats a thread at stride NT
  // (conflict-free), and are added to the second's. Each thread reads back
  // only what it wrote: no barrier.
  auto stash = [&](bool put) {
    float* st = reinterpret_cast<float*>(stash4) + tid;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* p = st + (i * 8 + j) * NT;
        if (put) {
          *p = acc[i][j];
          acc[i][j] = 0.f;
        } else {
          acc[i][j] = *p + acc[i][j];
        }
      }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) fetch(t + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][GR + ty * 4]);
      const float4 b00 =
          *reinterpret_cast<const float4*>(&Bs[buf][0][kk][tx * 4]);
      const float4 b01 =
          *reinterpret_cast<const float4*>(&Bs[buf][0][kk][64 + tx * 4]);
      const float4 b10 =
          *reinterpret_cast<const float4*>(&Bs[buf][1][kk][tx * 4]);
      const float4 b11 =
          *reinterpret_cast<const float4*>(&Bs[buf][1][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv0[8] = {b00.x, b00.y, b00.z, b00.w,
                            b01.x, b01.y, b01.z, b01.w};
      const float bv1[8] = {b10.x, b10.y, b10.z, b10.w,
                            b11.x, b11.y, b11.z, b11.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av[i], bv0[j], acc[i][j]);
          acc[4 + i][j] = fmaf(av[4 + i], bv1[j], acc[4 + i][j]);
        }
    }
    if ((TWO || TAIL) && J.nsrc == 2 && t == ktiles - 1) stash(true);
    // the other stage was last read before the previous barrier
    if (t + 1 < ntiles) stage(buf ^ 1);
    __syncthreads();
  }
  if ((TWO || TAIL) && J.nsrc == 2) stash(false);

  // epilogue: thread rows g*64 + 4*ty + i (i < 4) of the block's groups,
  // columns 4*tx + j and 64 + 4*tx + j; TAIL: the output's own strides
  const long long baseo =
      TAIL ? (long long)(blockIdx.z % a.batch) * a.pstrideo : base;
  float* C = J.C + baseo;
  const float* S = EPI == SUB ? J.S + baseo : nullptr;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = n0 + c * 64 + tx * 4;
    if (TRANS) {
      // rows are contiguous: per column, one float4 for each group
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (TAIL && n + j >= a.ncols) continue;
        float4 o[2];
        float* ov = reinterpret_cast<float*>(o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = acc[i][c * 4 + j], x1 = acc[4 + i][c * 4 + j];
          if (MODE == PINV) {
            ov[i] = x0 + x1;
            ov[4 + i] = x0 - x1;
          } else {
            ov[i] = x0;
            ov[4 + i] = x1;
          }
        }
        const long long cb = (long long)(n + j) * (TAIL ? a.ldo : a.ld);
        const int m0 = MODE == PINV ? mt * GR + ty * 4 : arow[0] + ty * 4;
        const int m1 = MODE == PINV ? (TAIL ? ho : a.h) + m0
                                    : arow[1] + ty * 4;
        if (!TAIL) {
          *reinterpret_cast<float4*>(C + cb + m0) = o[0];
          *reinterpret_cast<float4*>(C + cb + m1) = o[1];
          continue;
        }
        // one float a store (ldo need not be a multiple of 4), rows in
        // range; SOLVE: the x mode of the column and its table row
        const int xm = (n + j) / a.cpp;
        const long long tb = (long long)((n + j) % a.cpp) * a.ldo;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int m = g == 0 ? m0 : m1;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ty * 4 + i >= nv[MODE == PINV ? 0 : g]) continue;
            float v = ov[4 * g + i];
            if (EPI == SOLVE) {
              const float waves =
                  a.col[0][xm] * __ldg(a.tab[0] + tb + m + i)
                  + a.col[1][xm] * __ldg(a.tab[1] + tb + m + i);
              v *= fabsf(waves) >= 1e-16f ? -1.f / waves : 0.f;
              if (a.tab[2] != nullptr)
                v *= 1.f - a.col[2][xm] * __ldg(a.tab[2] + tb + m + i);
            }
            C[cb + m + i] = v;
          }
        }
      }
    } else {
      if (TAIL && n >= a.ncols) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (TAIL && ty * 4 + i >= nv[MODE == PINV ? 0 : g]) continue;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x0 = acc[i][c * 4 + j], x1 = acc[4 + i][c * 4 + j];
            v[j] = MODE == PINV ? (g == 0 ? x0 + x1 : x0 - x1)
                                : (g == 0 ? x0 : x1);
          }
          const int m = MODE == PINV
                            ? g * (TAIL ? ho : a.h) + mt * GR + ty * 4 + i
                            : arow[g] + ty * 4 + i;
          if (!TAIL && MODE == DENSE && m >= a.nout) continue;
          const long long off = (long long)m * (TAIL ? a.ldo : a.ld) + n;
          if (EPI == SUB) {
            const float4 s = ld4(S + off);
            v[0] = s.x - v[0];
            v[1] = s.y - v[1];
            v[2] = s.z - v[2];
            v[3] = s.w - v[3];
          } else if (EPI == SOLVE_PLANE) {
            // the x mode is the plane of the batch
            const int xm = (int)(blockIdx.z % a.batch);
            const float k2 = a.col[0][xm], t2 = a.col[1][xm];
            const float4 tA = ld4(a.tab[0] + off);
            const float4 tB = ld4(a.tab[1] + off);
            const float wa[4] = {tA.x, tA.y, tA.z, tA.w};
            const float wb[4] = {tB.x, tB.y, tB.z, tB.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float waves = k2 * wa[j] + t2 * wb[j];
              v[j] *= fabsf(waves) >= 1e-16f ? -1.f / waves : 0.f;
            }
            if (a.tab[2] != nullptr) {
              // the Nyquist line: q * (1 - mx * Myz)
              const float mx = a.col[2][xm];
              const float4 tm = ld4(a.tab[2] + off);
              v[0] *= 1.f - mx * tm.x;
              v[1] *= 1.f - mx * tm.y;
              v[2] *= 1.f - mx * tm.z;
              v[3] *= 1.f - mx * tm.w;
            }
          }
          *reinterpret_cast<float4*>(C + off) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

template <int MODE, bool TRANS, int EPI, bool TWO = false, bool TAIL = false>
cudaError_t launch(const Args& a, dim3 grid, bool two, cudaStream_t stream) {
  if (two) {
    // the stash is dynamic shared memory past the static 48 KB, opted in
    // on the current device; two blocks an SM still fit (2 x 89 KB). No
    // carveout hint: with CUDA's own choice the mid at 512^3 runs as
    // fast as with one chain, with the largest shared carveout (the
    // least L1) ~2% slower (tools/mid_probe.py)
    const cudaError_t e = cudaFuncSetAttribute(
        mat_apply_kernel<MODE, TRANS, EPI, TWO, TAIL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, STASH_BYTES);
    if (e != cudaSuccess) return e;
  }
  mat_apply_kernel<MODE, TRANS, EPI, TWO, TAIL>
      <<<grid, NT, two ? STASH_BYTES : 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Compile-time block geometry, for the wrapper's checks.
int pressure_pipe_geometry(int* bm, int* gr, int* bn, int* bk) {
  *bm = BM;
  *gr = GR;
  *bn = BN;
  *bk = BK;
  return 0;
}

// One launch of the operator apply. ptrs: per job A0, A1, B0, B1, C, S (6
// each, unused may be null); nsrc: sources per job; tabs: A, B, k2x, tx2,
// Myz, mx (the solves only, else null; Myz and mx null without a Nyquist
// mask).
// nout: the operator's rows. tail: the general instance (any extents,
// ldo, pstrideo and cpp read), else the 128-tiled one. Grid: (ncols / BN
// rounded up, mtiles, njobs * batch). Returns the cudaError_t of the
// launch (0 on success).
int pressure_pipe_apply(int mode, int trans, int epi, int njobs,
                        void* const* ptrs, const int* nsrc,
                        void* const* tabs, int batch, int K, int nrow,
                        int nout, int bw, long long ld, long long pstride,
                        long long ncols, int mtiles, int tail,
                        long long ldo, long long pstrideo, int cpp,
                        void* stream) {
  // DENSE transposed: square (the output's rows share the input's
  // stride), K tiled by the k-step and the rows by the block
  if (njobs < 1 || njobs > 3 || batch < 1 || mtiles < 1
      || (!tail && (ncols % BN || (mode != DENSE && K % BK)
                    || (mode == DENSE && trans
                        && (K % BK || nout != K || nout % BM))))
      || (tail && (ncols % 4 || K < 1 || cpp < 1
                   || (mode == BANDED && (trans || nrow % GR))
                   || ((mode == PFWD || mode == PINV) && nout % 2))))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int j = 0; j < njobs; ++j) {
    void* const* p = ptrs + 6 * j;
    a.job[j].A[0] = static_cast<const float*>(p[0]);
    a.job[j].A[1] = static_cast<const float*>(p[1]);
    a.job[j].B[0] = static_cast<const float*>(p[2]);
    a.job[j].B[1] = static_cast<const float*>(p[3]);
    a.job[j].C = static_cast<float*>(p[4]);
    a.job[j].S = static_cast<const float*>(p[5]);
    a.job[j].nsrc = nsrc[j];
  }
  for (int i = 0; i < 2; ++i) {
    a.tab[i] = static_cast<const float*>(tabs[i]);
    a.col[i] = static_cast<const float*>(tabs[2 + i]);
  }
  a.tab[2] = static_cast<const float*>(tabs[4]);
  a.col[2] = static_cast<const float*>(tabs[5]);
  a.batch = batch;
  a.K = K;
  a.nrow = nrow;
  a.nout = nout;
  a.h = nrow / 2;
  a.bw = bw;
  a.ld = ld;
  a.pstride = pstride;
  a.ldo = ldo;
  a.pstrideo = pstrideo;
  a.ncols = ncols;
  a.cpp = cpp;
  const dim3 grid((unsigned)((ncols + BN - 1) / BN), (unsigned)mtiles,
                  (unsigned)(njobs * batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool two = false;
  for (int j = 0; j < njobs; ++j) two = two || nsrc[j] == 2;
  const int key = mode * 100 + trans * 10 + epi;
  if (tail) {
    switch (key) {
      case BANDED * 100 + 0 + STORE:
        return launch<BANDED, false, STORE, false, true>(a, grid, two, s);
      case PFWD * 100 + 0 + STORE:
        return launch<PFWD, false, STORE, false, true>(a, grid, two, s);
      case PFWD * 100 + 0 + SOLVE_PLANE:
        return launch<PFWD, false, SOLVE_PLANE, false, true>(a, grid, two, s);
      case PFWD * 100 + 10 + STORE:
        return launch<PFWD, true, STORE, false, true>(a, grid, two, s);
      case PFWD * 100 + 10 + SOLVE:
        return launch<PFWD, true, SOLVE, false, true>(a, grid, two, s);
      case PINV * 100 + 0 + STORE:
        return launch<PINV, false, STORE, false, true>(a, grid, two, s);
      case PINV * 100 + 0 + SUB:
        return launch<PINV, false, SUB, false, true>(a, grid, two, s);
      case PINV * 100 + 10 + STORE:
        return launch<PINV, true, STORE, false, true>(a, grid, two, s);
      case DENSE * 100 + 0 + STORE:
        return launch<DENSE, false, STORE, false, true>(a, grid, two, s);
      case DENSE * 100 + 0 + SOLVE_PLANE:
        return launch<DENSE, false, SOLVE_PLANE, false, true>(a, grid, two, s);
      case DENSE * 100 + 10 + STORE:
        return launch<DENSE, true, STORE, false, true>(a, grid, two, s);
      case DENSE * 100 + 10 + SOLVE:
        return launch<DENSE, true, SOLVE, false, true>(a, grid, two, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (two) {
    // the forms that take two-source jobs: the mid's banded y (Iy du +
    // Sy dv) and z transforms (Iz . + Sz ., parity or dense)
    switch (key) {
      case BANDED * 100 + 0 + STORE:
        return launch<BANDED, false, STORE, true>(a, grid, true, s);
      case PFWD * 100 + 10 + STORE:
        return launch<PFWD, true, STORE, true>(a, grid, true, s);
      case DENSE * 100 + 10 + STORE:
        return launch<DENSE, true, STORE, true>(a, grid, true, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (key) {
    case BANDED * 100 + 0 + STORE:
      return launch<BANDED, false, STORE>(a, grid, false, s);
    case PFWD * 100 + 0 + STORE:
      return launch<PFWD, false, STORE>(a, grid, false, s);
    case PFWD * 100 + 0 + SOLVE_PLANE:
      return launch<PFWD, false, SOLVE_PLANE>(a, grid, false, s);
    case PFWD * 100 + 10 + STORE:
      return launch<PFWD, true, STORE>(a, grid, false, s);
    case PINV * 100 + 0 + STORE:
      return launch<PINV, false, STORE>(a, grid, false, s);
    case PINV * 100 + 0 + SUB:
      return launch<PINV, false, SUB>(a, grid, false, s);
    case PINV * 100 + 10 + STORE:
      return launch<PINV, true, STORE>(a, grid, false, s);
    case DENSE * 100 + 0 + STORE:
      return launch<DENSE, false, STORE>(a, grid, false, s);
    case DENSE * 100 + 0 + SOLVE_PLANE:
      return launch<DENSE, false, SOLVE_PLANE>(a, grid, false, s);
    case DENSE * 100 + 10 + STORE:
      return launch<DENSE, true, STORE>(a, grid, false, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pressure_pipe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
