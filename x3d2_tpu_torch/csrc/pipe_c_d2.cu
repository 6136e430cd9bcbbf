// Stage C of the pressure pipeline with the d2-in-C carry (X3D2_D2C=1),
// for Hopper (sm_90a), behind a plain C interface: the last of pipe_c[d2]'s
// three launches (ops/pressure_pipe.py pipe_c_d2).
//
// Replaces the TPU kernel _pipe_c_kernel with d2=True
// (x3d2_tpu/ops/pallas_poisson.py:1455, the carry at :1523-1552, built at
// :1681-1718): stage C of the projection, u' = u - Giy Gzi X,
// v' = v - Gsy Gzi Y, w' = w - Giy Gzs Y, plus the NEXT step's z transport
// partials of the corrected velocities while they are still on chip,
//     r_q = -1/2 (w' D1 q + D1d (q w')) + nu D2 q,   q in (u', v', w'),
// with (D1, D1d, D2) = (D1s, D1, D2s) for u', v' and (D1, D1s, D2) for w'
// (the z sweep, x3d2_tpu _pencil_kernel, pallas_kernels.py:671). The
// step's transport chain then starts at the x sweep with these partials,
// so the separate z sweep's three full-field reads leave the step.
//
// The y and z operators commute (pallas_poisson.py:386-410), so stage C
// runs y first: two launches of the operator-apply template
// (csrc/pressure_pipe.cu: the inverse y transform of X and Y, then the
// banded Giy, Gsy, Giy) give A_u = Giy Tyi X, A_v = Gsy Tyi Y,
// A_w = Giy Tyi Y, and this kernel finishes: u' = u - Gzi A_u,
// v' = v - Gzi A_v, w' = w - Gzs A_w, then the carry. A block owns 32
// whole z lines (the (x, y) columns b*32 ... b*32 + 31 of the row-major
// field) of all three fields in shared memory, [z][line] with the line
// stride padded to 36 floats (float4 rows; conflict-free per lane):
//   1. stage A_u, A_v, A_w (each warp load: 4 lines x 8 z, whose
//      transposed stores hit 32 distinct banks);
//   2. per field, the inverse parity z transform [a + b; a - b],
//      a = Me A_e, b = Mo A_o (Gz_i for u, v; Gz_s for w): a thread owns
//      R output rows of the half (2 at nz = 512, 3 at 384, 1 at 256)
//      for its share of the lines (16 at nz = 512, 8 at 384; z taken
//      periodically by a mask at the powers of two, by a compare at 384),
//      the operators streamed from L2
//      transposed (coalesced over the rows) and loaded KB = 8 rows ahead
//      of their use (one block a SM: the loads' latency is covered by the
//      thread's own FMAs, not by other warps), the lines' k-th values read
//      as float4 broadcasts, each feeding 8 R multiply-adds;
//      u' = s - (a +/- b) written to global memory once and over the
//      staged field in shared memory;
//   3. the carry's z sweep on the resident lines, lane = line: each
//      thread takes runs of 8 consecutive z outputs of one line and
//      slides an 8-value window of q and q w' over the 2W + 1 = 65 taps
//      of the circulant operators (periodic uniform z: every row is a
//      shift of the first, checked at build), three accumulations per
//      tap. W = 32: the compact-6 z operators drop 4e-14 of their
//      largest entry beyond it (x3d2_tpu's band for the carry is 64, at
//      128-point blocks: the dense operator to float64 rounding).
//
// Bound on an H100 at 512^3, for the whole of pipe_c[d2] (the function of
// the TPU kernel, stage C run y first): its parity products (2 inverse y,
// 3 inverse z transforms, 3 banded y applies and the subtraction: ~2.96e3
// flops per point) and the carry's 3 x 3 x 65 taps (~1.19e3) against 11
// field passes of device memory: bound by operations (~8.3 ms at 67
// TFLOP/s FP32, ~1.8 ms of bytes; chip_smoke.py carry_cost). What
// the design does: the carry costs no field pass (it reads the lines the
// transform left in shared memory), and the z transform's operand rows
// come from shared memory as broadcasts, 4 lines per load. The operator
// is read from L2 once per block and field (512 KB at nz = 512), the cost
// of owning whole lines: 32 lines a block is what the 227 KB of shared
// memory hold at nz = 512 (221 KB for the three fields). The y stage runs
// before it in two template launches, not stage C's three.
//
// Two forms, picked per launch by the wrapper (ops/pressure_pipe.py
// carry_geometry):
//   - resident (above): nz 256, 384 and 512, one instance each, the three
//     fields' lines in shared memory (3 nz (L + 4) floats: 221 KB at 512,
//     the most that fits);
//   - streamed: any nz that is a multiple of 128 (x3d2_tpu's carry gate,
//     pallas_poisson.py:1684-1686, has no upper bound; its slab's VMEM
//     estimate stops it at 1536 on 128 x 128 planes, a limit of the TPU's
//     scoped memory that the port does not take over), nz taken at run
//     time. A block still owns 32 whole lines, but holds none of them:
//       1. per field, the inverse parity z transform in passes of 128 rows
//          of the half (64 row groups of 2 rows, 8 lines a thread), the
//          operand A streamed through shared memory in steps of 32 rows
//          of each half (2 x 32 x 36 floats, 9 KB), the operators from L2
//          as in the resident form; u' = s - (a +/- b) written to global
//          memory once;
//       2. the carry in chunks of 128 z outputs: the chunk's q and w' with
//          their W = 32 halo on each side read back from the block's own
//          lines just written (L2; 2 x 192 x 36 floats, 54 KB), the
//          resident form's sliding window on them.
//     Shared memory 55 KB at every nz; the price is one read of the three
//     corrected fields (and of w' twice more) back from L2 with a 1.5x
//     halo, and A read once a pass: 3 + 3 x 1.5 + 3 ceil(nz / 256) field
//     passes of L2 traffic where the resident form has none. Bound and
//     times at 512 x 512 x 1024 and 128 x 128 x 640 ... 4096 on the H100:
//     PERF.md section 6 (chip_smoke.py carry_cost).

#include <cuda_runtime.h>

namespace {

constexpr int L = 32;            // z lines per block
constexpr int LP = L + 4;        // padded line stride of the shared tiles
constexpr int NT = 256;          // threads per block
constexpr int W = 32;            // the carry's band half-width
constexpr int NTAP = 2 * W + 1;  // taps per operator
constexpr int RUN = 8;           // consecutive z outputs per thread (carry)
constexpr int KB = 8;            // operator rows a thread loads ahead

struct CarryArgs {
  const float* A[3];   // A_u, A_v, A_w: (lines, nz)
  const float* S[3];   // u, v, w
  const float* G[2];   // [Me^T; Mo^T] (nz, nz/2) of Gz_i (u, v), Gz_s (w)
  const float* taps;   // (4, NTAP): D1, D1s, D2, D2s at offsets -W..W
  float* U[3];         // u', v', w'
  float* R[3];         // r_u, r_v, r_w
  float nu;
};

// a z index in [-W, NZ + W) taken periodically into [0, NZ)
template <int NZ>
__device__ __forceinline__ int wrap(int z) {
  if constexpr ((NZ & (NZ - 1)) == 0) {
    return z & (NZ - 1);
  } else {
    return z < 0 ? z + NZ : z >= NZ ? z - NZ : z;
  }
}

template <int NZ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * NZ * LP + 4 * NTAP);
}

// One k row of the inverse parity z transform: the row's R operator values
// of each half (me, mo) times the LPT staged lines' k-th values of the even
// (te) and odd (to) halves, each float4 feeding 4 R multiply-adds a half.
template <int R, int LPT>
__device__ __forceinline__ void transform_row(const float (&me)[R],
                                              const float (&mo)[R],
                                              const float* te,
                                              const float* to,
                                              float (&acc_a)[R][LPT],
                                              float (&acc_b)[R][LPT]) {
#pragma unroll
  for (int l = 0; l < LPT; l += 4) {
    const float4 e = *reinterpret_cast<const float4*>(te + l);
    const float4 o = *reinterpret_cast<const float4*>(to + l);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc_a[r][l] = fmaf(me[r], e.x, acc_a[r][l]);
      acc_a[r][l + 1] = fmaf(me[r], e.y, acc_a[r][l + 1]);
      acc_a[r][l + 2] = fmaf(me[r], e.z, acc_a[r][l + 2]);
      acc_a[r][l + 3] = fmaf(me[r], e.w, acc_a[r][l + 3]);
      acc_b[r][l] = fmaf(mo[r], o.x, acc_b[r][l]);
      acc_b[r][l + 1] = fmaf(mo[r], o.y, acc_b[r][l + 1]);
      acc_b[r][l + 2] = fmaf(mo[r], o.z, acc_b[r][l + 2]);
      acc_b[r][l + 3] = fmaf(mo[r], o.w, acc_b[r][l + 3]);
    }
  }
}

// The carry of RUN consecutive z outputs of the thread's line (lane): q
// (Tq) and the convecting w' (Tv) in [z][LP] tiles, the window of inputs
// z0 - W + k at offset row(k) (k < RUN + 2W), so the outputs' own points at
// row(j + W); slides an RUN-value window of q and q w' over the 2W + 1
// taps of the circulant operators (dq = cd q, d2 = c2 q, dd = cp (q w')),
// three accumulations per tap; writes the RUN partials to out.
template <typename Row>
__device__ __forceinline__ void carry_run(const float* Tq, const float* Tv,
                                          const float* cd, const float* c2,
                                          const float* cp, float nu, int lane,
                                          Row row, float* out) {
  float dq[RUN], d2[RUN], dd[RUN], qw[RUN], pw[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int o = row(j) + lane;
    const float q = Tq[o];
    qw[j] = q;
    pw[j] = q * Tv[o];
    dq[j] = d2[j] = dd[j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < NTAP; ++k) {
    const float wd = cd[k], w2 = c2[k], wp = cp[k];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      dq[j] = fmaf(wd, qw[j], dq[j]);
      d2[j] = fmaf(w2, qw[j], d2[j]);
      dd[j] = fmaf(wp, pw[j], dd[j]);
    }
    if (k + 1 < NTAP) {
      // slide: the window at offset k + 1 - W
#pragma unroll
      for (int j = 0; j < RUN - 1; ++j) {
        qw[j] = qw[j + 1];
        pw[j] = pw[j + 1];
      }
      const int o = row(RUN + k) + lane;
      const float q = Tq[o];
      qw[RUN - 1] = q;
      pw[RUN - 1] = q * Tv[o];
    }
  }
  float r[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const float conv = Tv[row(j + W) + lane];
    r[j] = -0.5f * (conv * dq[j] + dd[j]) + nu * d2[j];
  }
  *reinterpret_cast<float4*>(out) = make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(out + 4) = make_float4(r[4], r[5], r[6], r[7]);
}

template <int NZ>
__global__ void __launch_bounds__(NT, 1)
pipe_c_d2_kernel(const __grid_constant__ CarryArgs a) {
  constexpr int H = NZ / 2;
  extern __shared__ __align__(16) float smem[];
  float* T = smem;                    // [3][NZ][LP]
  float* C = smem + 3 * NZ * LP;      // [4][NTAP]
  const int tid = threadIdx.x;
  const long long line0 = (long long)blockIdx.x * L;

  for (int i = tid; i < 4 * NTAP; i += NT) C[i] = a.taps[i];

  // 1. stage: lanes (z 0..7, line 0..3) of a warp; 8 warps walk the tiles
  {
    const int zl = tid & 7, ll = (tid >> 3) & 3, warp = tid >> 5;
    for (int c = 0; c < 3; ++c) {
      const float* src = a.A[c] + line0 * NZ;
      float* dst = T + c * NZ * LP;
      for (int it = warp; it < (L / 4) * (NZ / 8); it += NT / 32) {
        const int l = (it % (L / 4)) * 4 + ll;
        const int z = (it / (L / 4)) * 8 + zl;
        dst[z * LP + l] = __ldg(src + (long long)l * NZ + z);
      }
    }
  }
  __syncthreads();

  // 2. the inverse parity z transforms and the correction: R output rows
  // of the half and LPT lines a thread (each float4 of a line's k-th
  // values feeds 8 R multiply-adds)
  constexpr int R = NZ == 384 ? 3 : NZ >= 512 ? 2 : 1;
  constexpr int NRG = H / R;            // row groups
  constexpr int LPT = L / (NT / NRG);   // lines per thread
  static_assert(NZ % 64 == 0 && NT % NRG == 0 && H % KB == 0
                    && LPT % 4 == 0,
                "NZ: an extent the block's row and line groups tile");
  const int rg = tid % NRG;
  const int lb = (tid / NRG) * LPT;
  for (int c = 0; c < 3; ++c) {
    const float* G = a.G[c == 2 ? 1 : 0];
    float* Tc = T + c * NZ * LP;
    const float* Ge = G + rg;
    const float* Go = G + H * H + rg;
    float acc_a[R][LPT], acc_b[R][LPT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int l = 0; l < LPT; ++l) acc_a[r][l] = acc_b[r][l] = 0.f;
    float me[KB][R], mo[KB][R];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        me[j][r] = __ldg(Ge + j * H + r * NRG);
        mo[j][r] = __ldg(Go + j * H + r * NRG);
      }
    for (int k0 = 0; k0 < H; k0 += KB) {
      const int kn = k0 + KB < H ? k0 + KB : k0;
      float nme[KB][R], nmo[KB][R];
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          nme[j][r] = __ldg(Ge + (kn + j) * H + r * NRG);
          nmo[j][r] = __ldg(Go + (kn + j) * H + r * NRG);
        }
#pragma unroll
      for (int j = 0; j < KB; ++j)
        transform_row<R, LPT>(me[j], mo[j], Tc + (k0 + j) * LP + lb,
                              Tc + (H + k0 + j) * LP + lb, acc_a, acc_b);
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          me[j][r] = nme[j][r];
          mo[j][r] = nmo[j][r];
        }
    }
    __syncthreads();   // every thread has read the staged field
    const float* S = a.S[c] + line0 * NZ;
    float* Uo = a.U[c] + line0 * NZ;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rg + r * NRG;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int ln = lb + l;
        const float u0 = __ldg(S + (long long)ln * NZ + i)
                         - (acc_a[r][l] + acc_b[r][l]);
        const float u1 = __ldg(S + (long long)ln * NZ + H + i)
                         - (acc_a[r][l] - acc_b[r][l]);
        Uo[(long long)ln * NZ + i] = u0;
        Uo[(long long)ln * NZ + H + i] = u1;
        Tc[i * LP + ln] = u0;
        Tc[(H + i) * LP + ln] = u1;
      }
    }
  }
  __syncthreads();

  // 3. the carry: lane = line, runs of RUN z outputs per warp in turn
  const int lane = tid & 31, warp = tid >> 5;
  const float* Tw = T + 2 * NZ * LP;   // w', the convecting component
  for (int c = 0; c < 3; ++c) {
    const float* Tq = T + c * NZ * LP;
    // dq = D1 q, d2q = D2 q, dqd = D1s (q w') for w'; D1s, D2s, D1 else
    const float* cd = C + (c == 2 ? 0 : 1) * NTAP;
    const float* c2 = C + (c == 2 ? 2 : 3) * NTAP;
    const float* cp = C + (c == 2 ? 1 : 0) * NTAP;
    float* Rc = a.R[c] + (line0 + lane) * NZ;
    for (int z0 = warp * RUN; z0 < NZ; z0 += (NT / 32) * RUN)
      carry_run(Tq, Tw, cd, c2, cp, a.nu, lane,
                [z0](int k) { return wrap<NZ>(z0 - W + k) * LP; }, Rc + z0);
  }
}

// ---------------------------------------------------------------------------
// the streamed form: nz at run time
// ---------------------------------------------------------------------------

constexpr int SLPT = 8;                 // lines a thread (transform)
constexpr int SNRG = NT / (L / SLPT);   // row groups a pass
constexpr int SR = 2;                   // rows of the half a row group
constexpr int SPASS = SNRG * SR;        // rows of the half a pass
constexpr int KC = 32;                  // rows of each half a staging step
constexpr int CZ = 128;                 // carry outputs a chunk
constexpr int CW = CZ + 2 * W;          // a chunk's rows with the halo
constexpr int S_STAGE = 2 * KC * LP;    // floats: A's staged step
constexpr int S_CARRY = 2 * CW * LP;    // floats: a chunk's q and w'
static_assert(SNRG * (L / SLPT) == NT && SLPT % 4 == 0
                  && CZ % (RUN * NT / 32) == 0,
              "the streamed form's thread groups tile the block");

constexpr size_t streamed_smem_bytes() {
  return sizeof(float) * ((S_CARRY > S_STAGE ? S_CARRY : S_STAGE)
                          + 4 * NTAP);
}

__global__ void __launch_bounds__(NT)
pipe_c_d2_streamed_kernel(const __grid_constant__ CarryArgs a, int nz) {
  const int H = nz / 2;
  extern __shared__ __align__(16) float smem[];
  float* C = smem;                 // [4][NTAP]
  float* T = smem + 4 * NTAP;      // the staged step or the chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long line0 = (long long)blockIdx.x * L;

  for (int i = tid; i < 4 * NTAP; i += NT) C[i] = a.taps[i];

  // 1. per field the inverse parity z transform and the correction, in
  // passes over the rows of the half; A streamed KC rows of each half a
  // step, each warp load 4 lines x 8 z (transposed stores on 32 banks)
  const int zl = tid & 7, ll = (tid >> 3) & 3;
  const int rg = tid % SNRG;
  const int lb = (tid / SNRG) * SLPT;
  for (int c = 0; c < 3; ++c) {
    const float* G = a.G[c == 2 ? 1 : 0];
    const float* src = a.A[c] + line0 * nz;
    const float* S = a.S[c] + line0 * nz;
    float* Uo = a.U[c] + line0 * nz;
    for (int p0 = 0; p0 < H; p0 += SPASS) {
      int row[SR];
      bool ok[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        row[r] = p0 + rg + r * SNRG;
        ok[r] = row[r] < H;
      }
      float acc_a[SR][SLPT], acc_b[SR][SLPT];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int l = 0; l < SLPT; ++l) acc_a[r][l] = acc_b[r][l] = 0.f;
      for (int k0 = 0; k0 < H; k0 += KC) {
        __syncthreads();   // the previous step's reads are done
        for (int it = warp; it < 2 * (L / 4) * (KC / 8); it += NT / 32) {
          const int half = it / ((L / 4) * (KC / 8));
          const int t = it % ((L / 4) * (KC / 8));
          const int l = (t % (L / 4)) * 4 + ll;
          const int z = (t / (L / 4)) * 8 + zl;
          T[(half * KC + z) * LP + l] =
              __ldg(src + (long long)l * nz + half * H + k0 + z);
        }
        __syncthreads();
        for (int j0 = 0; j0 < KC; j0 += 8) {
          float me[8][SR], mo[8][SR];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < SR; ++r) {
              const long long k = k0 + j0 + j;
              me[j][r] = ok[r] ? __ldg(G + k * H + row[r]) : 0.f;
              mo[j][r] = ok[r] ? __ldg(G + (H + k) * H + row[r]) : 0.f;
            }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            transform_row<SR, SLPT>(me[j], mo[j], T + (j0 + j) * LP + lb,
                                    T + (KC + j0 + j) * LP + lb, acc_a,
                                    acc_b);
        }
      }
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        if (!ok[r]) continue;
        const int i = row[r];
#pragma unroll
        for (int l = 0; l < SLPT; ++l) {
          const long long o = (long long)(lb + l) * nz;
          Uo[o + i] = __ldg(S + o + i) - (acc_a[r][l] + acc_b[r][l]);
          Uo[o + H + i] = __ldg(S + o + H + i) - (acc_a[r][l] - acc_b[r][l]);
        }
      }
    }
  }
  __syncthreads();   // u', v', w' of the block's lines are in memory

  // 2. the carry, chunk by chunk: rows [z0c - W, z0c + CZ + W) of q and w'
  // read back (plain loads: written by this kernel), lane = line
  float* Tq = T;             // [CW][LP]
  float* Tw = T + CW * LP;   // [CW][LP]
  const float* Wsrc = a.U[2] + line0 * nz;
  for (int c = 0; c < 3; ++c) {
    const float* Qsrc = a.U[c] + line0 * nz;
    const float* Tv = c == 2 ? Tq : Tw;   // w': the convecting component
    const float* cd = C + (c == 2 ? 0 : 1) * NTAP;
    const float* c2 = C + (c == 2 ? 2 : 3) * NTAP;
    const float* cp = C + (c == 2 ? 1 : 0) * NTAP;
    float* Rc = a.R[c] + (line0 + lane) * nz;
    for (int z0c = 0; z0c < nz; z0c += CZ) {
      for (int it = warp; it < (L / 4) * (CW / 8); it += NT / 32) {
        const int l = (it % (L / 4)) * 4 + ll;
        const int j = (it / (L / 4)) * 8 + zl;
        int z = z0c - W + j;
        z = z < 0 ? z + nz : z >= nz ? z - nz : z;
        const long long o = (long long)l * nz + z;
        Tq[j * LP + l] = Qsrc[o];
        if (c != 2) Tw[j * LP + l] = Wsrc[o];
      }
      __syncthreads();
      // the window rows: jz + k for the inputs z0c + jz - W + k
      for (int jz = warp * RUN; jz < CZ; jz += (NT / 32) * RUN)
        carry_run(Tq, Tv, cd, c2, cp, a.nu, lane,
                  [jz](int k) { return (jz + k) * LP; }, Rc + z0c + jz);
      __syncthreads();   // the chunk's reads are done
    }
  }
}

template <int NZ>
cudaError_t launch(const CarryArgs& a, long long nlines,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      pipe_c_d2_kernel<NZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<NZ>());
  if (err != cudaSuccess) return err;
  pipe_c_d2_kernel<NZ><<<(unsigned)(nlines / L), NT, smem_bytes<NZ>(),
                         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Compile-time geometry, for the wrapper's checks: lines per block, W,
// and of the streamed form the rows of the half a pass, the z outputs a
// chunk and its shared memory in bytes.
int pipe_c_d2_geometry(int* lines, int* w, int* pass_rows, int* chunk,
                       int* smem) {
  *lines = L;
  *w = W;
  *pass_rows = SPASS;
  *chunk = CZ;
  *smem = (int)streamed_smem_bytes();
  return 0;
}

// One launch. ptrs: A_u, A_v, A_w, u, v, w, Gz_i^T, Gz_s^T, taps, u', v',
// w', r_u, r_v, r_w (15, all 16-byte aligned, contiguous (lines, nz)
// fields). nlines = nx * ny, a multiple of 32. form 0: the resident form,
// nz 256, 384 or 512; form 1: the streamed form, nz a multiple of 128 (at
// least 256). Returns the cudaError_t of the launch (0 on success).
int pipe_c_d2_launch(void* const* ptrs, float nu, long long nlines, int nz,
                     int form, void* stream) {
  if (nlines <= 0 || nlines % L) return (int)cudaErrorInvalidValue;
  CarryArgs a = {};
  for (int c = 0; c < 3; ++c) {
    a.A[c] = static_cast<const float*>(ptrs[c]);
    a.S[c] = static_cast<const float*>(ptrs[3 + c]);
    a.U[c] = static_cast<float*>(ptrs[9 + c]);
    a.R[c] = static_cast<float*>(ptrs[12 + c]);
  }
  a.G[0] = static_cast<const float*>(ptrs[6]);
  a.G[1] = static_cast<const float*>(ptrs[7]);
  a.taps = static_cast<const float*>(ptrs[8]);
  a.nu = nu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (nz < 256 || nz % CZ) return (int)cudaErrorInvalidValue;
    const size_t smem = streamed_smem_bytes();
    const cudaError_t err = cudaFuncSetAttribute(
        pipe_c_d2_streamed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    pipe_c_d2_streamed_kernel<<<(unsigned)(nlines / L), NT, smem, s>>>(a,
                                                                        nz);
    return (int)cudaGetLastError();
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  switch (nz) {
    case 256: return (int)launch<256>(a, nlines, s);
    case 384: return (int)launch<384>(a, nlines, s);
    case 512: return (int)launch<512>(a, nlines, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* pipe_c_d2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
