// The y/z-tiled pressure mid for Hopper (sm_90a), behind a plain C
// interface: three kernels, one launch each per call.
//
// Replaces the TPU kernels of x3d2_tpu's tiled mid (make_mid_local.tiled,
// x3d2_tpu/ops/pallas_poisson.py:850-909), which the repencilled sharded
// projection takes where whole (y, z) planes exceed the TPU's VMEM (1024^2
// planes):
//   - _mid_t1_kernel  pallas_poisson.py:413  a = Ty (Iy du + Sy dv),
//                                            d = Ty (Iy dw)
//   - _mid_t2_kernel  pallas_poisson.py:430  F = Iz a + Sz d; q = -F / waves
//                                            (zero-wave guard, Nyquist
//                                            mask); p_z = Gzi q,
//                                            dpdz_s = Gzs q
//   - _mid_t3_kernel  pallas_poisson.py:468  GH = Ti_y [p_z | dpdz_s];
//                                            p_zy = Giy GH1, dpdy = Gsy GH1,
//                                            dpdz = Giy GH2
// on each x plane of a rank's batch of nx_loc planes (row-major (nx_loc, ny,
// nz) float32 fields, z contiguous). The mid's y and z operators commute,
// so the merged mid (csrc/pressure_pipe.cu's six launches) is regrouped as
// y operators, z operators, y operators, each group on tiles of the axis it
// does not contract: t1 and t3 on column tiles (all of y, TC z columns), t2
// on row tiles (TC y rows, all of z). The operators are those of the slab
// projection (ops/parity.py ProjectionMats): the y interpolation and
// staggered derivative band-truncated per block of 64 rows (window 128 =
// 64 + 2 * 32, periodic wrap), passed tap-major per block (nb, 128, 64);
// the transforms as parity splits [Me; Mo] (n, n/2): forward
// [Me (f1 + f2); Mo (f1 - f2)] (Ty, Iz, Sz), inverse [a + b; a - b] with
// a = Me f_e, b = Mo f_o (Gzi, Gzs, and Ti_y with its row weights folded
// in). Spectral indices are in block-parity order on y and z, as t1 leaves
// them and as the solve tables (q_perm rows, z_perm columns) are permuted.
//
// What each block keeps on chip, as its TPU twin keeps it in VMEM:
//   t1  the banded results Iy du + Sy dv and Iy dw of its (ny, 16) column
//       tile (32 KB a field at ny = 1024), combined in place to
//       (f1 + f2; f1 - f2), as the operand of the forward y transform;
//   t2  the combined a and d of its (16, nz) row tile (64 KB each, k-major),
//       then q in a's place, the operand of both inverse z transforms;
//   t3  p_z and dpdz_s of its (ny, 16) column tile, then GH in their place,
//       the operand of the banded y applies.
// The transforms' operators stream from L2 through shared memory in
// k-steps of 8 rows (double-buffered, the next step's loads issued before
// the current step's FMAs, one barrier a step); each thread holds 4 rows of
// each half (2 in t2) x 8 columns of accumulators, so the parity pairs
// (rows m and h + m) meet in its registers for the inverse combine. The
// banded applies run one warp per 64-row block, 8 rows x 4 columns of each
// result a lane, their windows read from device memory (t1) or from the
// staged tile (t3). SIMT FP32 FMA throughout.
//
// Bound on an H100 at 32 x 1024 x 1024 (the batch of TGV 128 x 1024^2 on a
// (2, 2) mesh): the mid needs per point 2 forward z, 1 forward y, 2 inverse
// z and 2 inverse y transforms (n/2 multiply-adds and a combine each) and 6
// banded applies (65 taps each): about 8.0e3 operations a point, 4.0 ms at
// the 67 TFLOP/s FP32 rate, against its 7 field passes (3 in, q and 3 out:
// 0.28 ms at 3.35 TB/s): bound by operations. The tiled order does one
// forward y transform more (a and d each), 8.4% more operations, and moves
// 15 field passes: the price of tiling. The limits of this form (the wide
// one): n <= 1024 along the axis a kernel transforms (a staged tile of 1024
// rows of 32 floats and the operator step fill 192 KB of the 227 KB a block
// may hold), y a multiple of 64 and z of 16.
//
// Past 1024 points along the axis it transforms, a kernel takes its long
// form (chosen per launch by ops/pressure_slab.py tiled_geometry; x3d2_tpu's
// gate admits up to 3968 points along y and 2560 along z at terms 2):
//   - one field a block for t1 and t3 (blockIdx.z: a or d; p_z or dpdz_s),
//     TCL = 16 columns where the transform's 2 x 4 rows a thread x 8
//     columns cover the axis (n <= 2048), else TCL = 8 (n <= 4096); t2
//     keeps both a and d of TCL rows (TCL = 16 up to 1664 points, 8 up to
//     3548);
//   - the staged tile alone in shared memory (n x TCL floats a field:
//     128 KB at n = 4096, TCL = 8; t2 2 x 2560 x 8 floats, 160 KB, at its
//     2560); the transforms' operators are read by each thread straight
//     from L2, transposed ((h, 2h): a k row's 4 rows of each half one
//     float4, coalesced), two k rows ahead, with no barrier in the k loop.
// The sums are the wide form's, in the same order: each output a
// multiply-add chain over k = 0 .. h - 1, the banded applies tap by tap.
// The price: 8 or 16 columns a block read the operator from L2 where the
// wide form's 32 do.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int BW = 32;             // band half-width of the y operators
constexpr int BBS = 64;            // rows per banded block
constexpr int WIN = BBS + 2 * BW;  // taps per banded row
constexpr int TC = 16;             // one field's columns (t1, t3) or rows
                                   // (t2) per tile
constexpr int BK = 8;              // k-step of the transforms
constexpr int MAXN = 1024;         // most points along y or z
constexpr int LDB = 2 * TC;        // staged row of t1 and t3: two fields
constexpr float EPS = 1e-16f;      // zero-wave guard

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared-memory floats of the operator steps of a transform over n points.
__host__ __device__ constexpr int a_stage_floats(int n) {
  return 2 * BK * (n + 4);
}

// One parity transform of a staged operand, accumulated into acc:
//   acc[g][i][j] += sum_k A[g h + m0 + i][k] * B[g h + k][c0 + j]
// for k < h, g = 0, 1 (the operator's halves Me, Mo; the operand's rows
// [0, h) and [h, 2h): f1 + f2 and f1 - f2 for a forward transform, the
// even and the odd modes for an inverse one), B[k][c] = Bs[k * LDBS + c].
// A: the stacked (2h, h) operator, row-major in device memory; As: the
// block's 2 x BK x (2h + 4) floats. Every thread stages its share of A;
// threads with m0 >= h compute nothing (`active`). Ends on a barrier.
template <int RPT, int LDBS>
__device__ void transform(const float* __restrict__ A, int h,
                          const float* Bs, float* As, int m0, int c0,
                          bool active, float (&acc)[2][RPT][8]) {
  const int tid = threadIdx.x;
  const int ap = 2 * h + 4;
  float4 ra[2][2];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = tid + r * NT;
      if (row < 2 * h) {
        const float* p = A + (long long)row * h + kt;
        ra[r][0] = ld4(p);
        ra[r][1] = ld4(p + 4);
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = tid + r * NT;
      if (row < 2 * h) {
        float* d = As + buf * BK * ap + row;
        const float v[8] = {ra[r][0].x, ra[r][0].y, ra[r][0].z, ra[r][0].w,
                            ra[r][1].x, ra[r][1].y, ra[r][1].z, ra[r][1].w};
#pragma unroll
        for (int k = 0; k < BK; ++k) d[k * ap] = v[k];
      }
    }
  };
  const int nk = h / BK;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) fetch((t + 1) * BK);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float* a = As + (buf * BK + kk) * ap;
        float a0[RPT], a1[RPT];
        if constexpr (RPT == 4) {
          const float4 x = lds4(a + m0), y = lds4(a + h + m0);
          a0[0] = x.x; a0[1] = x.y; a0[2] = x.z; a0[3] = x.w;
          a1[0] = y.x; a1[1] = y.y; a1[2] = y.z; a1[3] = y.w;
        } else {
          static_assert(RPT == 2, "4 or 2 rows of each half a thread");
          const float2 x = *reinterpret_cast<const float2*>(a + m0);
          const float2 y = *reinterpret_cast<const float2*>(a + h + m0);
          a0[0] = x.x; a0[1] = x.y;
          a1[0] = y.x; a1[1] = y.y;
        }
        const int k = t * BK + kk;
        const float* b = Bs + k * LDBS + c0;
        const float* bo = Bs + (h + k) * LDBS + c0;
        const float4 b00 = lds4(b), b01 = lds4(b + 4);
        const float4 b10 = lds4(bo), b11 = lds4(bo + 4);
        const float b0[8] = {b00.x, b00.y, b00.z, b00.w,
                             b01.x, b01.y, b01.z, b01.w};
        const float b1[8] = {b10.x, b10.y, b10.z, b10.w,
                             b11.x, b11.y, b11.z, b11.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[0][i][j] = fmaf(a0[i], b0[j], acc[0][i][j]);
            acc[1][i][j] = fmaf(a1[i], b1[j], acc[1][i][j]);
          }
      }
    }
    // the other stage was last read before the previous barrier
    if (t + 1 < nk) stage(buf ^ 1);
    __syncthreads();
  }
}

template <int RPT>
__device__ __forceinline__ void zero(float (&acc)[2][RPT][8]) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][i][j] = 0.f;
}

// The first window row of banded block b, tap t (periodic in y).
__device__ __forceinline__ int window_row(int b, int t, int ny) {
  int r = b * BBS - BW + t;
  if (r < 0) r += ny;
  if (r >= ny) r -= ny;
  return r;
}

// The 8 rows r0.. of banded block b at tap t, from a tap-major operator
// stack (nb, WIN, BBS).
__device__ __forceinline__ void band_taps(const float* __restrict__ W,
                                          int b, int t, int r0, float* w) {
  const float* p = W + ((long long)b * WIN + t) * BBS + r0;
  const float4 x = ld4(p), y = ld4(p + 4);
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  w[4] = y.x; w[5] = y.y; w[6] = y.z; w[7] = y.w;
}

// _mid_t1_kernel: grid (nz / TC, nx_loc). a, d: (nx_loc, ny, nz), y modes in
// block-parity order.
__global__ void __launch_bounds__(NT, 1)
mid_t1_kernel(const float* __restrict__ du, const float* __restrict__ dv,
              const float* __restrict__ dw, const float* __restrict__ biy,
              const float* __restrict__ bsy, const float* __restrict__ ty,
              float* __restrict__ a_out, float* __restrict__ d_out, int ny,
              int nz) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [ny][LDB]
  float* As = Bs + ny * LDB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pbase = (long long)blockIdx.y * ny * nz;
  const int z0 = blockIdx.x * TC;

  // 1. banded y: Iy du + Sy dv into columns [0, TC), Iy dw into [TC, 2TC)
  {
    const int r0 = (lane & 7) * 8, c0 = (lane >> 3) * 4;
    for (int b = warp; b < ny / BBS; b += NWARP) {
      float uv[8][4], ww[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) uv[i][j] = ww[i][j] = 0.f;
#pragma unroll 2
      for (int t = 0; t < WIN; ++t) {
        const long long off =
            pbase + (long long)window_row(b, t, ny) * nz + z0 + c0;
        const float4 fu = ld4(du + off), fv = ld4(dv + off),
                     fw = ld4(dw + off);
        float wi[8], ws[8];
        band_taps(biy, b, t, r0, wi);
        band_taps(bsy, b, t, r0, ws);
        const float u4[4] = {fu.x, fu.y, fu.z, fu.w};
        const float v4[4] = {fv.x, fv.y, fv.z, fv.w};
        const float w4[4] = {fw.x, fw.y, fw.z, fw.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uv[i][j] = fmaf(ws[i], v4[j], fmaf(wi[i], u4[j], uv[i][j]));
            ww[i][j] = fmaf(wi[i], w4[j], ww[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = Bs + (b * BBS + r0 + i) * LDB;
        st4(row + c0, uv[i]);
        st4(row + TC + c0, ww[i]);
      }
    }
  }
  __syncthreads();
  // 2. the forward parity combine in place: rows k < h take f1 + f2, rows
  // h + k take f1 - f2
  const int h = ny / 2;
  for (int e = tid; e < h * LDB; e += NT) {
    const int k = e / LDB, c = e - k * LDB;
    const float x1 = Bs[k * LDB + c], x2 = Bs[(k + h) * LDB + c];
    Bs[k * LDB + c] = x1 + x2;
    Bs[(k + h) * LDB + c] = x1 - x2;
  }
  __syncthreads();
  // 3. the forward y transform [Te; To] of both fields
  const int cg = tid & 3, m0 = (tid >> 2) * 4, c0 = cg * 8;
  const bool active = m0 < h;
  float acc[2][4][8];
  zero(acc);
  transform<4, LDB>(ty, h, Bs, As, m0, c0, active, acc);
  if (!active) return;
  float* out = (c0 < TC ? a_out : d_out) + pbase + z0 + (c0 & (TC - 1));
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = out + (long long)(g * h + m0 + i) * nz;
      st4(p, acc[g][i]);
      st4(p + 4, acc[g][i] + 4);
    }
}

// _mid_t2_kernel: grid (ny / TC, nx_loc). tabA, tabB, Myz: (ny, nz) in the
// modes' order; k2x, tx2, mx: the batch's per-plane slices (Myz and mx null
// without a Nyquist mask). q, p_z, dpdz_s: (nx_loc, ny, nz).
__global__ void __launch_bounds__(NT, 1)
mid_t2_kernel(const float* __restrict__ a_in, const float* __restrict__ d_in,
              const float* __restrict__ iz, const float* __restrict__ sz,
              const float* __restrict__ gzi, const float* __restrict__ gzs,
              const float* __restrict__ tabA, const float* __restrict__ tabB,
              const float* __restrict__ myz, const float* __restrict__ k2x,
              const float* __restrict__ tx2, const float* __restrict__ mx,
              float* __restrict__ q_out, float* __restrict__ pz_out,
              float* __restrict__ dz_out, int ny, int nz) {
  extern __shared__ float4 smem4[];
  float* Ba = reinterpret_cast<float*>(smem4);   // [nz][TC], k-major
  float* Bd = Ba + nz * TC;
  float* As = Bd + nz * TC;
  const int tid = threadIdx.x;
  const int plane = blockIdx.y;
  const long long pbase = (long long)plane * ny * nz;
  const int y0 = blockIdx.x * TC;
  const int h = nz / 2;

  // 1. the tile's a and d, combined for the forward z transforms and
  // stored k-major (row k of the operand: column k of the fields)
  for (int e = tid; e < TC * h; e += NT) {
    const int n = e / h, k = e - n * h;
    const long long off = pbase + (long long)(y0 + n) * nz + k;
    const float a1 = __ldg(a_in + off), a2 = __ldg(a_in + off + h);
    const float d1 = __ldg(d_in + off), d2 = __ldg(d_in + off + h);
    Ba[k * TC + n] = a1 + a2;
    Ba[(h + k) * TC + n] = a1 - a2;
    Bd[k * TC + n] = d1 + d2;
    Bd[(h + k) * TC + n] = d1 - d2;
  }
  __syncthreads();
  // 2. F = Sz d + Iz a (Sz first: for the low z modes, which carry the
  // solution after the solve, Sz's part is the small one), modes m = g h +
  // m0 + i in block-parity order, rows y0 + c0 + j
  const int cg = tid & 1, m0 = (tid >> 1) * 2, c0 = cg * 8;
  const bool active = m0 < h;
  float acc[2][2][8];
  zero(acc);
  transform<2, TC>(sz, h, Bd, As, m0, c0, active, acc);
  transform<2, TC>(iz, h, Ba, As, m0, c0, active, acc);
  // 3. the solve: q = F * -1/waves (0 where |waves| < EPS) * (1 - mx Myz)
  const float k2 = k2x[plane], t2 = tx2[plane];
  const float mxp = mx != nullptr ? mx[plane] : 0.f;
  if (active) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int y = y0 + c0 + j;
        const long long tn = (long long)y * nz + g * h + m0;
        float q2[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float waves = k2 * __ldg(tabA + tn + i)
                              + t2 * __ldg(tabB + tn + i);
          float q = acc[g][i][j] * (fabsf(waves) >= EPS ? -1.f / waves
                                                         : 0.f);
          if (myz != nullptr) q *= 1.f - mxp * __ldg(myz + tn + i);
          acc[g][i][j] = q2[i] = q;
        }
        *reinterpret_cast<float2*>(q_out + pbase + tn) =
            make_float2(q2[0], q2[1]);
      }
  }
  // the transforms ended on a barrier: a's operand is dead, q takes it
  if (active) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Ba[(g * h + m0 + i) * TC + c0 + j] = acc[g][i][j];
  }
  __syncthreads();
  // 4. the inverse z transforms of q: p_z = Gzi q, dpdz_s = Gzs q, physical
  // z j and h + j from a +/- b
  for (int f = 0; f < 2; ++f) {
    zero(acc);
    transform<2, TC>(f == 0 ? gzi : gzs, h, Ba, As, m0, c0, active, acc);
    if (!active) continue;
    float* out = (f == 0 ? pz_out : dz_out) + pbase;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* p = out + (long long)(y0 + c0 + j) * nz + m0;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[0][0][j] + acc[1][0][j],
                      acc[0][1][j] + acc[1][1][j]);
      *reinterpret_cast<float2*>(p + h) =
          make_float2(acc[0][0][j] - acc[1][0][j],
                      acc[0][1][j] - acc[1][1][j]);
    }
  }
}

// _mid_t3_kernel: grid (nz / TC, nx_loc). tyi: [Me; Mo] of the inverse y
// transform with its row weights; p_zy, dpdy, dpdz: (nx_loc, ny, nz).
__global__ void __launch_bounds__(NT, 1)
mid_t3_kernel(const float* __restrict__ pz, const float* __restrict__ dz,
              const float* __restrict__ tyi, const float* __restrict__ bgiy,
              const float* __restrict__ bgsy, float* __restrict__ pzy_out,
              float* __restrict__ dpdy_out, float* __restrict__ dpdz_out,
              int ny, int nz) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [ny][LDB]
  float* As = Bs + ny * LDB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pbase = (long long)blockIdx.y * ny * nz;
  const int z0 = blockIdx.x * TC;
  const int h = ny / 2;

  // 1. the tile of p_z (columns [0, TC)) and dpdz_s ([TC, 2TC))
  for (int e = tid; e < ny * (LDB / 4); e += NT) {
    const int y = e / (LDB / 4), part = e - y * (LDB / 4);
    const int f = part / (TC / 4), q = part - f * (TC / 4);
    const float4 v = ld4((f == 0 ? pz : dz) + pbase + (long long)y * nz + z0
                         + 4 * q);
    *reinterpret_cast<float4*>(Bs + y * LDB + f * TC + 4 * q) = v;
  }
  __syncthreads();
  // 2. GH = Ti_y [p_z | dpdz_s]: a = Me (even modes), b = Mo (odd modes);
  // physical y m and h + m from a +/- b
  {
    const int cg = tid & 3, m0 = (tid >> 2) * 4, c0 = cg * 8;
    const bool active = m0 < h;
    float acc[2][4][8];
    zero(acc);
    transform<4, LDB>(tyi, h, Bs, As, m0, c0, active, acc);
    // the transform ended on a barrier: the staged tile is dead
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s[8], d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = acc[0][i][j] + acc[1][i][j];
          d[j] = acc[0][i][j] - acc[1][i][j];
        }
        float* p = Bs + (m0 + i) * LDB + c0;
        float* q = Bs + (h + m0 + i) * LDB + c0;
        st4(p, s);
        st4(p + 4, s + 4);
        st4(q, d);
        st4(q + 4, d + 4);
      }
    }
  }
  __syncthreads();
  // 3. banded y: p_zy = Giy GH1, dpdy = Gsy GH1 (one pass), dpdz = Giy GH2
  const int r0 = (lane & 7) * 8, c0 = (lane >> 3) * 4;
  for (int b = warp; b < ny / BBS; b += NWARP) {
    {
      float pi[8][4], ps[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pi[i][j] = ps[i][j] = 0.f;
#pragma unroll 2
      for (int t = 0; t < WIN; ++t) {
        const float4 g = lds4(Bs + window_row(b, t, ny) * LDB + c0);
        const float g4[4] = {g.x, g.y, g.z, g.w};
        float wi[8], ws[8];
        band_taps(bgiy, b, t, r0, wi);
        band_taps(bgsy, b, t, r0, ws);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pi[i][j] = fmaf(wi[i], g4[j], pi[i][j]);
            ps[i][j] = fmaf(ws[i], g4[j], ps[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long off =
            pbase + (long long)(b * BBS + r0 + i) * nz + z0 + c0;
        st4(pzy_out + off, pi[i]);
        st4(dpdy_out + off, ps[i]);
      }
    }
    float pd[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pd[i][j] = 0.f;
#pragma unroll 2
    for (int t = 0; t < WIN; ++t) {
      const float4 g = lds4(Bs + window_row(b, t, ny) * LDB + TC + c0);
      const float g4[4] = {g.x, g.y, g.z, g.w};
      float wi[8];
      band_taps(bgiy, b, t, r0, wi);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pd[i][j] = fmaf(wi[i], g4[j], pd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st4(dpdz_out + pbase + (long long)(b * BBS + r0 + i) * nz + z0 + c0,
          pd[i]);
  }
}

// ---------------------------------------------------------------------------
// the long form: n > MAXN along the transformed axis
// ---------------------------------------------------------------------------

// One parity transform of a staged operand with the operator read from L2:
//   acc[g][i][j] += sum_k A[g h + m0 + i][k] * B[g h + k][c0 + j]
// as transform() but At = A transposed, (h, 2h) row-major (At[k][g h + m]
// = A[g h + m][k]), and the operand's rows TCL floats apart. No barrier.
template <int TCL>
__device__ __forceinline__ void transform_l2(const float* __restrict__ At,
                                             int h, const float* Bs, int m0,
                                             int c0, float (&acc)[2][4][8]) {
  const float* p = At + m0;
  const long long ld = 2LL * h;
  float4 ca[2], cb[2], na[2], nb[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    ca[u] = ld4(p + u * ld);
    cb[u] = ld4(p + u * ld + h);
  }
  for (int k = 0; k < h; k += 2) {
    if (k + 2 < h) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        na[u] = ld4(p + (k + 2 + u) * ld);
        nb[u] = ld4(p + (k + 2 + u) * ld + h);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float a0[4] = {ca[u].x, ca[u].y, ca[u].z, ca[u].w};
      const float a1[4] = {cb[u].x, cb[u].y, cb[u].z, cb[u].w};
      const float* b = Bs + (k + u) * TCL + c0;
      const float* bo = Bs + (h + k + u) * TCL + c0;
      const float4 b00 = lds4(b), b01 = lds4(b + 4);
      const float4 b10 = lds4(bo), b11 = lds4(bo + 4);
      const float b0[8] = {b00.x, b00.y, b00.z, b00.w,
                           b01.x, b01.y, b01.z, b01.w};
      const float b1[8] = {b10.x, b10.y, b10.z, b10.w,
                           b11.x, b11.y, b11.z, b11.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][i][j] = fmaf(a0[i], b0[j], acc[0][i][j]);
          acc[1][i][j] = fmaf(a1[i], b1[j], acc[1][i][j]);
        }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

// The banded y apply of one field's (ny, TCL) tile, 8 rows x 4 columns a
// lane, a unit (block b, column group) per 8 lanes: Iy u + Sy v (two
// sources, ws non-null) or Iy u; u, v: the first window row's columns,
// rows `stride` floats apart, read by ld (device memory or the staged
// tile). Calls out(b, r0, cg, res) with the unit's 8 x 4 results.
template <int TCL, typename Load, typename Out>
__device__ __forceinline__ void banded_units(int ny, const float* wi_op,
                                             const float* ws_op, Load ld,
                                             Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (lane & 7) * 8;
  const int nunits = (ny / BBS) * (TCL / 4);
  for (int u = warp * 4 + (lane >> 3); u < nunits; u += NWARP * 4) {
    const int b = u / (TCL / 4), cg = u - b * (TCL / 4);
    float res[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) res[i][j] = 0.f;
#pragma unroll 2
    for (int t = 0; t < WIN; ++t) {
      const int row = window_row(b, t, ny);
      float wi[8];
      band_taps(wi_op, b, t, r0, wi);
      const float4 fu = ld(0, row, cg);
      const float u4[4] = {fu.x, fu.y, fu.z, fu.w};
      if (ws_op != nullptr) {
        float ws[8];
        band_taps(ws_op, b, t, r0, ws);
        const float4 fv = ld(1, row, cg);
        const float v4[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            res[i][j] = fmaf(ws[i], v4[j], fmaf(wi[i], u4[j], res[i][j]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            res[i][j] = fmaf(wi[i], u4[j], res[i][j]);
      }
    }
    out(b, r0, cg, res);
  }
}

// _mid_t1_kernel, long form: grid (nz / TCL, nx_loc, 2); field 0 a = Ty (Iy
// du + Sy dv), field 1 d = Ty (Iy dw). tyt: [Te; To] transposed, (h, 2h).
template <int TCL>
__global__ void __launch_bounds__(NT, 1)
mid_t1_long_kernel(const float* __restrict__ du, const float* __restrict__ dv,
                   const float* __restrict__ dw, const float* __restrict__ biy,
                   const float* __restrict__ bsy,
                   const float* __restrict__ tyt, float* __restrict__ a_out,
                   float* __restrict__ d_out, int ny, int nz) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [ny][TCL]
  const int tid = threadIdx.x;
  const int f = blockIdx.z;
  const long long pbase = (long long)blockIdx.y * ny * nz;
  const int z0 = blockIdx.x * TCL;
  const float* s0 = (f == 0 ? du : dw) + pbase + z0;
  const float* s1 = dv + pbase + z0;

  // 1. banded y into the tile
  banded_units<TCL>(
      ny, biy, f == 0 ? bsy : nullptr,
      [&](int src, int row, int cg) {
        return ld4((src == 0 ? s0 : s1) + (long long)row * nz + cg * 4);
      },
      [&](int b, int r0, int cg, float (&res)[8][4]) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          st4(Bs + (b * BBS + r0 + i) * TCL + cg * 4, res[i]);
      });
  __syncthreads();
  // 2. the forward parity combine in place
  const int h = ny / 2;
  for (int e = tid; e < h * TCL; e += NT) {
    const float x1 = Bs[e], x2 = Bs[e + h * TCL];
    Bs[e] = x1 + x2;
    Bs[e + h * TCL] = x1 - x2;
  }
  __syncthreads();
  // 3. the forward y transform
  const int m0 = (tid / (TCL / 8)) * 4, c0 = (tid % (TCL / 8)) * 8;
  if (m0 >= h) return;
  float acc[2][4][8];
  zero(acc);
  transform_l2<TCL>(tyt, h, Bs, m0, c0, acc);
  float* out = (f == 0 ? a_out : d_out) + pbase + z0 + c0;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = out + (long long)(g * h + m0 + i) * nz;
      st4(p, acc[g][i]);
      st4(p + 4, acc[g][i] + 4);
    }
}

// _mid_t2_kernel, long form: grid (ny / TCL, nx_loc); the operators
// transposed, (h, 2h); arguments otherwise mid_t2_kernel's.
template <int TCL>
__global__ void __launch_bounds__(NT, 1)
mid_t2_long_kernel(const float* __restrict__ a_in,
                   const float* __restrict__ d_in,
                   const float* __restrict__ izt, const float* __restrict__ szt,
                   const float* __restrict__ gzit,
                   const float* __restrict__ gzst,
                   const float* __restrict__ tabA,
                   const float* __restrict__ tabB,
                   const float* __restrict__ myz, const float* __restrict__ k2x,
                   const float* __restrict__ tx2, const float* __restrict__ mx,
                   float* __restrict__ q_out, float* __restrict__ pz_out,
                   float* __restrict__ dz_out, int ny, int nz) {
  extern __shared__ float4 smem4[];
  float* Ba = reinterpret_cast<float*>(smem4);   // [nz][TCL], k-major
  float* Bd = Ba + nz * TCL;
  const int tid = threadIdx.x;
  const int plane = blockIdx.y;
  const long long pbase = (long long)plane * ny * nz;
  const int y0 = blockIdx.x * TCL;
  const int h = nz / 2;

  // 1. the tile's a and d, combined and stored k-major
  for (int e = tid; e < TCL * h; e += NT) {
    const int n = e / h, k = e - n * h;
    const long long off = pbase + (long long)(y0 + n) * nz + k;
    const float a1 = __ldg(a_in + off), a2 = __ldg(a_in + off + h);
    const float d1 = __ldg(d_in + off), d2 = __ldg(d_in + off + h);
    Ba[k * TCL + n] = a1 + a2;
    Ba[(h + k) * TCL + n] = a1 - a2;
    Bd[k * TCL + n] = d1 + d2;
    Bd[(h + k) * TCL + n] = d1 - d2;
  }
  __syncthreads();
  const int m0 = (tid / (TCL / 8)) * 4, c0 = (tid % (TCL / 8)) * 8;
  const bool active = m0 < h;
  float acc[2][4][8];
  zero(acc);
  // 2. F = Sz d + Iz a
  if (active) {
    transform_l2<TCL>(szt, h, Bd, m0, c0, acc);
    transform_l2<TCL>(izt, h, Ba, m0, c0, acc);
  }
  // 3. the solve
  const float k2 = k2x[plane], t2 = tx2[plane];
  const float mxp = mx != nullptr ? mx[plane] : 0.f;
  if (active) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int y = y0 + c0 + j;
        const long long tn = (long long)y * nz + g * h + m0;
        float q4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float waves = k2 * __ldg(tabA + tn + i)
                              + t2 * __ldg(tabB + tn + i);
          float q = acc[g][i][j] * (fabsf(waves) >= EPS ? -1.f / waves
                                                         : 0.f);
          if (myz != nullptr) q *= 1.f - mxp * __ldg(myz + tn + i);
          acc[g][i][j] = q4[i] = q;
        }
        st4(q_out + pbase + tn, q4);
      }
  }
  __syncthreads();   // every thread has read a's operand: q takes it
  if (active) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Ba[(g * h + m0 + i) * TCL + c0 + j] = acc[g][i][j];
  }
  __syncthreads();
  // 4. the inverse z transforms of q
  if (!active) return;
  for (int f = 0; f < 2; ++f) {
    zero(acc);
    transform_l2<TCL>(f == 0 ? gzit : gzst, h, Ba, m0, c0, acc);
    float* out = (f == 0 ? pz_out : dz_out) + pbase;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s4[4], d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4[i] = acc[0][i][j] + acc[1][i][j];
        d4[i] = acc[0][i][j] - acc[1][i][j];
      }
      float* p = out + (long long)(y0 + c0 + j) * nz + m0;
      st4(p, s4);
      st4(p + h, d4);
    }
  }
}

// _mid_t3_kernel, long form: grid (nz / TCL, nx_loc, 2); field 0 p_z ->
// p_zy = Giy GH1, dpdy = Gsy GH1; field 1 dpdz_s -> dpdz = Giy GH2. tyit:
// the inverse y transform with its row weights, transposed (h, 2h).
template <int TCL>
__global__ void __launch_bounds__(NT, 1)
mid_t3_long_kernel(const float* __restrict__ pz, const float* __restrict__ dz,
                   const float* __restrict__ tyit,
                   const float* __restrict__ bgiy,
                   const float* __restrict__ bgsy,
                   float* __restrict__ pzy_out, float* __restrict__ dpdy_out,
                   float* __restrict__ dpdz_out, int ny, int nz) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [ny][TCL]
  const int tid = threadIdx.x;
  const int f = blockIdx.z;
  const long long pbase = (long long)blockIdx.y * ny * nz;
  const int z0 = blockIdx.x * TCL;
  const int h = ny / 2;

  // 1. the field's tile
  const float* src = (f == 0 ? pz : dz) + pbase + z0;
  for (int e = tid; e < ny * (TCL / 4); e += NT) {
    const int y = e / (TCL / 4), q = e - y * (TCL / 4);
    *reinterpret_cast<float4*>(Bs + y * TCL + 4 * q) =
        ld4(src + (long long)y * nz + 4 * q);
  }
  __syncthreads();
  // 2. GH = Ti_y of the tile, over it once every thread has read it
  const int m0 = (tid / (TCL / 8)) * 4, c0 = (tid % (TCL / 8)) * 8;
  const bool active = m0 < h;
  float acc[2][4][8];
  zero(acc);
  if (active) transform_l2<TCL>(tyit, h, Bs, m0, c0, acc);
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s8[8], d8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s8[j] = acc[0][i][j] + acc[1][i][j];
        d8[j] = acc[0][i][j] - acc[1][i][j];
      }
      float* p = Bs + (m0 + i) * TCL + c0;
      float* q = Bs + (h + m0 + i) * TCL + c0;
      st4(p, s8);
      st4(p + 4, s8 + 4);
      st4(q, d8);
      st4(q + 4, d8 + 4);
    }
  }
  __syncthreads();
  // 3. banded y: p_zy = Giy GH1 and dpdy = Gsy GH1, or dpdz = Giy GH2
  auto from_tile = [&](int, int row, int cg) {
    return lds4(Bs + row * TCL + cg * 4);
  };
  auto store = [&](float* dst) {
    return [=](int b, int r0, int cg, float (&res)[8][4]) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st4(dst + pbase + (long long)(b * BBS + r0 + i) * nz + z0 + cg * 4,
            res[i]);
    };
  };
  if (f == 0) {
    banded_units<TCL>(ny, bgiy, nullptr, from_tile, store(pzy_out));
    banded_units<TCL>(ny, bgsy, nullptr, from_tile, store(dpdy_out));
  } else {
    banded_units<TCL>(ny, bgiy, nullptr, from_tile, store(dpdz_out));
  }
}

size_t smem_bytes(int stage, int tcl, int ny, int nz) {
  if (tcl != 0)
    return sizeof(float) * (stage == 2 ? 2 * nz * tcl : ny * tcl);
  if (stage == 2) return sizeof(float) * (2 * nz * TC + a_stage_floats(nz));
  return sizeof(float) * (ny * LDB + a_stage_floats(ny));
}

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Compile-time geometry, for the wrapper's checks: the wide form's tile
// (columns or rows of one field), the band half-width, the banded block,
// the wide form's most points along the transformed axis, and the long
// form's: threads a block (4 rows of each half a thread, 8 columns).
int pressure_mid_tiled_geometry(int* tc, int* bw, int* bbs, int* maxn,
                                int* nt) {
  *tc = TC;
  *bw = BW;
  *bbs = BBS;
  *maxn = MAXN;
  *nt = NT;
  return 0;
}

// One launch of kernel `stage` (1, 2, 3) over nx planes of (ny, nz), in the
// wide form (tcl 0: n <= MAXN along the axis the kernel transforms) or the
// long one with tcl = 8 or 16 columns (t1, t3) or rows (t2) a block. ptrs:
//   1: du, dv, dw, biy, bsy (tap-major (ny/64, 128, 64)), ty, a, d
//   2: a, d, iz, sz, gzi, gzs, tabA, tabB, Myz, k2x, tx2, mx (Myz and mx
//      null without a Nyquist mask), q, p_z, dpdz_s
//   3: p_z, dpdz_s, tyi, bgiy, bgsy (tap-major), p_zy, dpdy, dpdz
// the transforms [Me; Mo] (n, n/2) in the wide form, transposed (n/2, n)
// in the long one. Returns the cudaError_t of the launch (0 on success).
int pressure_mid_tiled_launch(int stage, int tcl, void* const* ptrs, int nx,
                              int ny, int nz, void* stream) {
  const int n = stage == 2 ? nz : ny;
  const int tile = tcl == 0 ? TC : tcl;
  if (nx < 1 || nx > 65535 || ny < BBS || ny % BBS || nz < TC || nz % TC
      || (stage == 2 ? ny : nz) % tile
      || (tcl == 0 && n > MAXN)
      || (tcl != 0 && (tcl != 8 && tcl != 16)))
    return (int)cudaErrorInvalidValue;
  // the long form: 4 rows of each half a thread, 8 columns
  if (tcl != 0 && (n / 2) > NT * 4 / (tcl / 8))
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto o = [&](int i) { return static_cast<float*>(ptrs[i]); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(stage, tcl, ny, nz);
  cudaError_t e;
  if (tcl != 0) {
    const dim3 g1(nz / tcl, nx, 2), g2(ny / tcl, nx);
#define X3D2_LONG(TCV)                                                       \
    switch (stage) {                                                         \
      case 1:                                                                \
        e = prepare(mid_t1_long_kernel<TCV>, smem);                          \
        if (e != cudaSuccess) return (int)e;                                 \
        mid_t1_long_kernel<TCV><<<g1, NT, smem, s>>>(                        \
            f(0), f(1), f(2), f(3), f(4), f(5), o(6), o(7), ny, nz);         \
        break;                                                               \
      case 2:                                                                \
        e = prepare(mid_t2_long_kernel<TCV>, smem);                          \
        if (e != cudaSuccess) return (int)e;                                 \
        mid_t2_long_kernel<TCV><<<g2, NT, smem, s>>>(                        \
            f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9),      \
            f(10), f(11), o(12), o(13), o(14), ny, nz);                      \
        break;                                                               \
      case 3:                                                                \
        e = prepare(mid_t3_long_kernel<TCV>, smem);                          \
        if (e != cudaSuccess) return (int)e;                                 \
        mid_t3_long_kernel<TCV><<<g1, NT, smem, s>>>(                        \
            f(0), f(1), f(2), f(3), f(4), o(5), o(6), o(7), ny, nz);         \
        break;                                                               \
      default:                                                               \
        return (int)cudaErrorInvalidValue;                                   \
    }
    if (tcl == 8) {
      X3D2_LONG(8)
    } else {
      X3D2_LONG(16)
    }
#undef X3D2_LONG
    return (int)cudaGetLastError();
  }
  switch (stage) {
    case 1:
      e = prepare(mid_t1_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      mid_t1_kernel<<<dim3(nz / TC, nx), NT, smem, s>>>(
          f(0), f(1), f(2), f(3), f(4), f(5), o(6), o(7), ny, nz);
      break;
    case 2:
      e = prepare(mid_t2_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      mid_t2_kernel<<<dim3(ny / TC, nx), NT, smem, s>>>(
          f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10),
          f(11), o(12), o(13), o(14), ny, nz);
      break;
    case 3:
      e = prepare(mid_t3_kernel, smem);
      if (e != cudaSuccess) return (int)e;
      mid_t3_kernel<<<dim3(nz / TC, nx), NT, smem, s>>>(
          f(0), f(1), f(2), f(3), f(4), o(5), o(6), o(7), ny, nz);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* pressure_mid_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
