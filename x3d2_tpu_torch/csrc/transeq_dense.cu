// One direction of the skew-symmetric transport RHS on dense operator
// matrices, for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel _kernel of x3d2_tpu/ops/pallas_transeq.py:42
// (make_fused_transeq :124, pallas_call :170), which x3d2_tpu runs on the
// grids its banded sweeps cannot tile (fused_transeq_supported, :183:
// sweep extents up to 256, e.g. a 128-point z axis). For the sweep axis
// and each component q of (u, v, w), with conv the component aligned with
// the axis:
//     rhs_q = -1/2 (conv * D1 q + D1d (q * conv)) + nu * D2 q
// (D1, D1d, D2) = (der1st, der1st_sym, der2nd) for the aligned component
// and (der1st_sym, der1st, der2nd_sym) for the two transverse ones. No
// accumulation: the solver sums the three directions, as x3d2_tpu does.
//
// The contraction as two products per component over the n points of a
// line (n <= 256): acc1 = D1 q (K = n) and acc2 = A2 [q * conv; q] with
// A2 = [-1/2 D1d | nu D2] (K = 2n, the scale factors folded into the
// operator in float64 on the host); the epilogue forms
// rhs = -1/2 conv * acc1 + acc2. One block owns 64 points of the sweep
// axis for 128 lines, the rows of acc1 and acc2 for the same points
// side by side (the two 64-row groups of a 128-row tile), so the
// epilogue needs no exchange. The k-loop runs in two phases: over
// q * conv (formed while staging the operand; only acc2 takes it), then
// over q (both take it). The TPU kernel holds a full line tile and one
// row block of the six n x n operators in VMEM; here a 256 x 256 float32
// operator alone (256 KB) exceeds the 227 KB of shared memory a block may
// use, so operator and field are both streamed through shared memory in
// k-steps of 8, double-buffered, the next step's global loads issued
// before the current step's multiply-adds.
//
// The x and y sweeps contract along a strided axis: x over rows of
// ny * nz, y batched over x planes over rows of nz; their lines are
// contiguous, so a k-step stages 8 rows of 128 lines with float4 loads.
// The z sweep contracts along the contiguous axis (TRANS): a k-step
// stages 8 consecutive points of 128 lines, float4 along the line.
//
// Bound on an H100 at 128^3: 3 n multiply-adds per point and component,
// 9 n per point per direction (4.8 GFLOP a direction at n = 128), about
// 72 us at the 67 TFLOP/s FP32 rate, against 6 field passes (50 MB,
// 15 us at 3.35 TB/s): bound by operations. The multiply-adds run in
// FP32 FMA (the TPU kernel's HIGHEST mode is float32-accurate too),
// 8 x 8 outputs a thread, two blocks of 256 threads per SM.

#include <cuda_runtime.h>

namespace {

constexpr int GR = 64;    // sweep-axis points per block (rows of a group)
constexpr int BN = 128;   // lines per block
constexpr int BK = 8;     // k-step
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // shared-memory row pad (keeps float4 alignment)

struct Job {
  const float* q;      // the component
  float* out;          // its RHS along this axis
  const float* d1;     // (n, n) row-major: D1 of its pairing
  const float* a2;     // (n, 2n) row-major: [-1/2 D1d | nu D2]
};

struct Args {
  Job job[3];
  const float* conv;   // the component aligned with the sweep axis
  int batch;           // planes per job: blockIdx.z = job * batch + plane
  int n;               // points along the sweep axis
  long long ld;        // stride of a sweep-axis point (TRANS: of a line)
  long long pstride;   // stride between the planes of a batch
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 mul4(float4 x, float4 y) {
  return make_float4(x.x * y.x, x.y * y.y, x.z * y.z, x.w * y.w);
}

// EXACT: n is a multiple of the 64-point row tile (and so of the k-step);
// otherwise (an x extent such as 96) the loads past n read as zeros and
// the stores past n are skipped. TRANS needs EXACT (the wrapper checks).
template <bool TRANS, bool EXACT>
__global__ void __launch_bounds__(NT, 2)
transeq_dense_kernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) float As[2][BK][2 * GR + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const Job& J = a.job[blockIdx.z / a.batch];
  const long long base = (long long)(blockIdx.z % a.batch) * a.pstride;
  const int n = a.n;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * GR;
  const float* q = J.q + base;
  const float* cv = a.conv + base;

  // staging assignment: A as (row tid/2, k 4*(tid&1)), rows 0-63 from D1
  // and 64-127 from A2 for the block's 64 points; B as (k tid/32, line
  // 4*(tid&31)), or transposed (line tid/2, k 4*(tid&1))
  const int am = tid >> 1;
  const int ak = (tid & 1) * 4;
  const int arow = r0 + (am & (GR - 1));
  const bool second = am >= GR;
  const int bk = TRANS ? (tid & 1) * 4 : tid >> 5;
  const int bn = TRANS ? tid >> 1 : (tid & 31) * 4;
  const int ktiles = (n + BK - 1) / BK;
  const int ntiles = 2 * ktiles;   // phase 0: q * conv; phase 1: q

  float4 ra, rb;
  auto fetch = [&](int t) {
    const int ph = t >= ktiles;
    const int kt = (t - ph * ktiles) * BK;
    // operator: phase 0 only A2's first half feeds (acc2); phase 1 D1
    // (acc1) and A2's second half (acc2)
    const float* arow_p = second ? J.a2 + (long long)arow * 2 * n + ph * n
                                 : J.d1 + (long long)arow * n;
    if (EXACT) {
      ra = (second || ph) ? ld4(arow_p + kt + ak)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kt + ak + i;
        v[i] = ((second || ph) && arow < n && k < n) ? __ldg(arow_p + k)
                                                     : 0.f;
      }
      ra = make_float4(v[0], v[1], v[2], v[3]);
    }
    // field operand: q, times conv in phase 0
    const int k = kt + bk;
    const long long off = TRANS ? (long long)(n0 + bn) * a.ld + k
                                : (long long)k * a.ld + n0 + bn;
    if (EXACT || k < n) {
      rb = ld4(q + off);
      if (!ph) rb = mul4(rb, ld4(cv + off));
    } else {
      rb = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage = [&](int buf) {
    As[buf][ak + 0][am] = ra.x;
    As[buf][ak + 1][am] = ra.y;
    As[buf][ak + 2][am] = ra.z;
    As[buf][ak + 3][am] = ra.w;
    if (TRANS) {
      Bs[buf][bk + 0][bn] = rb.x;
      Bs[buf][bk + 1][bn] = rb.y;
      Bs[buf][bk + 2][bn] = rb.z;
      Bs[buf][bk + 3][bn] = rb.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = rb;
    }
  };

  // acc[i][.]: acc1 rows r0 + 4 ty + i; acc[4 + i][.]: acc2, same rows;
  // columns 4 tx + j and 64 + 4 tx + j (j < 4)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) fetch(t + 1);
    const bool both = t >= ktiles;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][GR + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av0[4] = {a0.x, a0.y, a0.z, a0.w};
      const float av1[4] = {a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if (both) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av0[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[4 + i][j] = fmaf(av1[i], bv[j], acc[4 + i][j]);
    }
    // the other stage was last read before the previous barrier
    if (t + 1 < ntiles) stage(buf ^ 1);
    __syncthreads();
  }

  // epilogue: rhs = -1/2 conv * acc1 + acc2
  float* out = J.out + base;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = n0 + c * 64 + tx * 4;
    if (TRANS) {
      // a line's points are contiguous: per line, one float4 of 4 points
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long off = (long long)(col + j) * a.ld + r0 + ty * 4;
        const float4 cw = ld4(cv + off);
        const float cvv[4] = {cw.x, cw.y, cw.z, cw.w};
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = fmaf(-0.5f * cvv[i], acc[i][c * 4 + j],
                      acc[4 + i][c * 4 + j]);
        *reinterpret_cast<float4*>(out + off) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (!EXACT && row >= n) continue;
        const long long off = (long long)row * a.ld + col;
        const float4 cw = ld4(cv + off);
        const float cvv[4] = {cw.x, cw.y, cw.z, cw.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = fmaf(-0.5f * cvv[j], acc[i][c * 4 + j],
                      acc[4 + i][c * 4 + j]);
        *reinterpret_cast<float4*>(out + off) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <bool TRANS, bool EXACT>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  transeq_dense_kernel<TRANS, EXACT><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Compile-time block geometry, for the wrapper's checks.
int transeq_dense_geometry(int* gr, int* bn, int* bk) {
  *gr = GR;
  *bn = BN;
  *bk = BK;
  return 0;
}

// One direction: ptrs per job q, out, d1, a2 (4 each, njobs jobs); conv
// the aligned component. Grid: (ncols / BN, ceil(n / GR), njobs * batch).
// Returns the cudaError_t of the launch (0 on success).
int transeq_dense_launch(int trans, int njobs, void* const* ptrs,
                         const void* conv, int batch, int n, long long ld,
                         long long pstride, long long ncols, void* stream) {
  const bool exact = n % GR == 0;
  if (njobs < 1 || njobs > 3 || batch < 1 || n < 1 || ncols % BN
      || (trans && !exact))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int j = 0; j < njobs; ++j) {
    void* const* p = ptrs + 4 * j;
    a.job[j].q = static_cast<const float*>(p[0]);
    a.job[j].out = static_cast<float*>(p[1]);
    a.job[j].d1 = static_cast<const float*>(p[2]);
    a.job[j].a2 = static_cast<const float*>(p[3]);
  }
  a.conv = static_cast<const float*>(conv);
  a.batch = batch;
  a.n = n;
  a.ld = ld;
  a.pstride = pstride;
  const dim3 grid((unsigned)(ncols / BN), (unsigned)((n + GR - 1) / GR),
                  (unsigned)(njobs * batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans) return launch<true, true>(a, grid, s);
  return exact ? launch<false, true>(a, grid, s)
               : launch<false, false>(a, grid, s);
}

const char* transeq_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
