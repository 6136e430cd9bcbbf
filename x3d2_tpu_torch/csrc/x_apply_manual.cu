// The x apply with its own multi-stage copy pipeline, for Hopper (sm_90a),
// behind a plain C interface: out = M @_x f, or out = s - M @_x f, for M
// (n_out, n_in) float32 and f (n_in, ny, nz) float32 in three forms:
//   DENSE  out = M f;
//   FWD    the forward parity split of a transform-folded M:
//          [E; O] = [Me (f1 + f2); Mo (f1 - f2)], f1, f2 the halves of f;
//   INV    the inverse one: [a + b; a - b], a = Me f_e, b = Mo f_o (with
//          or without the subtraction from s).
// FWD and INV take the stacked [Me; Mo] (n_out, n_in / 2).
//
// Replaces the TPU kernel of x3d2_tpu's manual-DMA x apply
// (make_x_apply_manual, x3d2_tpu/ops/pallas_manual.py:62; its inner
// `kernel` :114, pl.pallas_call :200): one gridless kernel that drives its
// own S-slot HBM <-> VMEM pipeline over (y, z) tiles, with a lookahead of
// S - 2 tiles and the output DMAs overlapped. No path of the solver calls
// it, in x3d2_tpu or here; tools/prof_manual.py is its entry point.
//
// Bound on an H100 at 512^3: 2 n_in multiply-adds an output (n_in / 2 in
// the parity forms), 2.7e11 (1.4e11) operations, about 4.1 (2.1) ms at the
// 67 TFLOP/s FP32 rate, against 2 field passes (3 with s) of device
// memory, about 0.32 (0.48) ms at 3.35 TB/s: bound by operations.
//
// What the design does about it: a persistent kernel, one block of 256
// threads an SM, walks work items (a pass of up to TR = 256 output rows,
// and a tile of BN = 32 columns of the (y, z) plane), block b taking items
// b, b + grid, ... Each item's contraction is cut into chunks of KC = 16
// k: the operator's KC x TR block (the operator is passed transposed, (K,
// n_out), so a thread's 8 rows are two float4 reads of shared memory) and
// the field's KC x BN block (FWD: the two halves' blocks) are copied into
// one of S shared-memory stages by cp.async (16 bytes a copy where the
// rows are aligned, else 4; rows and k past the ends zero-filled), S - 1
// chunks ahead of the one in use, and
// the chunk sequence runs on from one item into the next: the stores of
// item i's outputs (from registers) overlap the loads of item i + 1's
// first chunks. The stages are handed over by cp.async commit groups and
// one block barrier a chunk (not mbarriers). A thread holds 8 rows x 4
// columns of sums (INV: both a and b, the second source's chunks following
// the first's), f32 multiply-adds in k order, as the template's x apply.
// The operator is read again for every column tile (from L2: at 512 it is
// 1 MB), s with the output in the epilogue (not through the stages). S is
// a launch parameter (2 to 8; default 4, as in the JAX).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads a block
constexpr int TR = 256;       // output rows an item (a pass)
constexpr int BN = 32;        // columns an item
constexpr int KC = 16;        // k a chunk
constexpr int TRP = TR + 4;   // padded k-row of the operator's stage block
constexpr int MAX_S = 8;

enum { DENSE = 0, FWD = 1, INV = 2 };

struct ManualArgs {
  const float* M;   // the operator transposed, (K, n_out): DENSE K = n_in;
                    // FWD, INV K = n_in / 2 ([Me; Mo] transposed)
  const float* f;   // (n_in, ncols)
  const float* s;   // (n_out, ncols) or null
  float* out;       // (n_out, ncols)
  int nout;
  int K;
  long long ncols;
  int ctiles;       // ncols / BN
  int passes;       // row passes: of n_out (DENSE) or of n_out / 2
  int nitems;
  int slots;        // S
};

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n commit groups are pending (n = S - 2, 0 .. 6)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// floats of one stage: the transposed operator's KC x TR block (k-rows
// padded to TRP) and the field's KC x BN block (FWD: both halves')
template <int FORM>
constexpr int STAGE_FLOATS = KC * TRP + (FORM == FWD ? 2 : 1) * KC * BN;

// one chunk's multiply-adds into a thread's 8 x 4 sums: rows 8 ty .. 8 ty
// + 7, columns 4 tx .. 4 tx + 3; FWD combines the halves' blocks first,
// f1 + f2 (f1 - f2 for the odd half)
template <int FORM>
__device__ __forceinline__ void chunk_fma(float (&acc)[8][4],
                                          const float* As, const float* Bs,
                                          bool odd, int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    float4 b = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
    if (FORM == FWD) {
      const float4 b2 =
          *reinterpret_cast<const float4*>(Bs + (KC + kk) * BN + tx * 4);
      b = odd ? make_float4(b.x - b2.x, b.y - b2.y, b.z - b2.z, b.w - b2.w)
              : make_float4(b.x + b2.x, b.y + b2.y, b.z + b2.z, b.w + b2.w);
    }
    const float bv[4] = {b.x, b.y, b.z, b.w};
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * TRP + ty * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * TRP + ty * 8 + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int FORM, bool SUB>
__global__ void __launch_bounds__(NT, 1)
x_apply_manual_kernel(const __grid_constant__ ManualArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NB = FORM == FWD ? 2 : 1;     // field blocks a chunk
  constexpr int NSRC = FORM == INV ? 2 : 1;   // sources an item
  constexpr int SF = STAGE_FLOATS<FORM>;
  const int tid = threadIdx.x;
  const int tx = tid & 7;     // columns 4 tx .. 4 tx + 3
  const int ty = tid >> 3;    // rows 8 ty .. 8 ty + 7
  const int S = a.slots;
  const int K = a.K;
  const int ho = a.nout / 2;
  const int nk = (K + KC - 1) / KC;
  const int per_item = NSRC * nk;
  const int my_items =
      a.nitems > (int)blockIdx.x
          ? (a.nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nchunks = my_items * per_item;
  // whole 16-byte copies of the operator's rows where they are aligned
  const bool vec_a = (a.nout & 3) == 0 && (FORM == DENSE || (ho & 3) == 0);

  // an item: its first output row (the a + b row in INV), its rows in
  // range, its first operator row, its first column
  struct Item {
    int orow, nrows, arow;
    long long c0;
  };
  auto item_of = [&](int j) {
    const int it = (int)blockIdx.x + j * (int)gridDim.x;
    const int ct = it % a.ctiles;
    const int rest = it / a.ctiles;
    const int pass = rest % a.passes;
    Item m;
    m.c0 = (long long)ct * BN;
    if (FORM == DENSE) {
      m.orow = m.arow = pass * TR;
      m.nrows = a.nout - pass * TR;
    } else {
      const int half = FORM == FWD ? rest / a.passes : 0;
      m.orow = m.arow = half * ho + pass * TR;
      m.nrows = ho - pass * TR;
    }
    if (m.nrows > TR) m.nrows = TR;
    return m;
  };

  // a position in the block's chunk sequence, advanced one chunk at a
  // time (no division in the loop): item j (its geometry m), chunk c of
  // it, stage s of the ring
  struct Pos {
    int j, c, s;
    Item m;
  };
  auto advance = [&](Pos& p) {
    if (++p.s == S) p.s = 0;
    if (++p.c == per_item) {
      p.c = 0;
      if (++p.j < my_items) p.m = item_of(p.j);
    }
  };

  int gi = 0;                       // chunks requested
  Pos pi = {0, 0, 0, item_of(0)};   // the next chunk to request
  auto request = [&]() {
    if (gi < nchunks) {
      const Item& m = pi.m;
      const int src = pi.c >= nk;   // INV: the second source's chunks
      const int k0 = (pi.c - src * nk) * KC;
      float* As = smem + pi.s * SF;
      float* Bs = As + KC * TRP;
      const int arow = m.arow + (src == 1 ? ho : 0);
      // the transposed operator's rows k0 .. k0 + KC - 1, columns (output
      // rows) arow .. arow + TR - 1
      if (vec_a) {
#pragma unroll
        for (int i = 0; i < TR * KC / 4 / NT; ++i) {
          const int q = tid + i * NT;
          const int kk = q / (TR / 4), r = (q % (TR / 4)) * 4;
          const bool ok = r < m.nrows && k0 + kk < K;
          cp16(As + kk * TRP + r,
               ok ? a.M + (long long)(k0 + kk) * a.nout + arow + r : a.M,
               ok);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < TR * KC / NT; ++i) {
          const int q = tid + i * NT;
          const int kk = q / TR, r = q % TR;
          const bool ok = r < m.nrows && k0 + kk < K;
          cp4(As + kk * TRP + r,
              ok ? a.M + (long long)(k0 + kk) * a.nout + arow + r : a.M, ok);
        }
      }
      if (tid < NB * KC * BN / 4) {
        const int b = tid / (KC * BN / 4);
        const int q = tid % (KC * BN / 4);
        const int kk = q / (BN / 4), cq = (q % (BN / 4)) * 4;
        const int k = k0 + kk;
        // the operand rows: f (DENSE), f1 and f2 (FWD), f_e or f_o (INV)
        const int frow = k + (b == 1 || src == 1 ? K : 0);
        const bool ok = k < K;
        cp16(Bs + (b * KC + kk) * BN + cq,
             ok ? a.f + (long long)frow * a.ncols + m.c0 + cq : a.f, ok);
      }
      advance(pi);
    }
    ++gi;
    commit();
  };

  float acc0[8][4], acc1[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  for (int g = 0; g < S - 1; ++g) request();
  Pos pc = {0, 0, 0, item_of(0)};   // the chunk in use
  for (int g = 0; g < nchunks; ++g) {
    wait_pending(S - 2);
    __syncthreads();   // chunk g landed for all; stage (g - 1) % S is free
    request();
    const int c = pc.c;
    const Item m = pc.m;
    const float* As = smem + pc.s * SF;
    const float* Bs = As + KC * TRP;
    if (FORM == INV && c >= nk) {
      chunk_fma<FORM>(acc1, As, Bs, false, tx, ty);
    } else {
      chunk_fma<FORM>(acc0, As, Bs, FORM == FWD && m.orow >= ho, tx, ty);
    }
    advance(pc);
    if (c != per_item - 1) continue;
    // the item's last chunk: its outputs, while the next item's chunks
    // are in flight
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r < m.nrows) {
#pragma unroll
        for (int h = 0; h < (FORM == INV ? 2 : 1); ++h) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = FORM != INV ? acc0[i][j]
                   : h == 0 ? acc0[i][j] + acc1[i][j]
                            : acc0[i][j] - acc1[i][j];
          const long long off =
              (long long)(m.orow + h * ho + r) * a.ncols + m.c0 + tx * 4;
          if (SUB) {
            const float4 sv =
                __ldg(reinterpret_cast<const float4*>(a.s + off));
            v[0] = sv.x - v[0];
            v[1] = sv.y - v[1];
            v[2] = sv.z - v[2];
            v[3] = sv.w - v[3];
          }
          *reinterpret_cast<float4*>(a.out + off) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int FORM, bool SUB>
cudaError_t launch(const ManualArgs& a, int grid, cudaStream_t stream) {
  const int bytes = a.slots * STAGE_FLOATS<FORM> * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      x_apply_manual_kernel<FORM, SUB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  x_apply_manual_kernel<FORM, SUB><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Compile-time geometry, for the wrapper's checks: rows an item, columns
// an item, k a chunk, the most stages.
int x_apply_manual_geometry(int* tr, int* bn, int* kc, int* max_s) {
  *tr = TR;
  *bn = BN;
  *kc = KC;
  *max_s = MAX_S;
  return 0;
}

// One launch. form: 0 dense, 1 parity forward, 2 parity inverse; M (the
// operator transposed), f, s (null without the subtraction), out as
// ManualArgs; ncols = ny * nz, a
// multiple of BN; slots 2 .. MAX_S; grid: blocks (the SM count). Returns
// the cudaError_t of the launch (0 on success).
int x_apply_manual_launch(int form, const void* M, const void* f,
                          const void* s, void* out, int nout, int K,
                          long long ncols, int slots, int grid,
                          void* stream) {
  if (form < DENSE || form > INV || (form == FWD && s != nullptr)
      || nout < 1 || K < 1 || ncols % BN || slots < 2 || slots > MAX_S
      || grid < 1 || (form != DENSE && nout % 2))
    return (int)cudaErrorInvalidValue;
  ManualArgs a = {};
  a.M = static_cast<const float*>(M);
  a.f = static_cast<const float*>(f);
  a.s = static_cast<const float*>(s);
  a.out = static_cast<float*>(out);
  a.nout = nout;
  a.K = K;
  a.ncols = ncols;
  a.ctiles = (int)(ncols / BN);
  const int rows = form == DENSE ? nout : nout / 2;
  a.passes = (rows + TR - 1) / TR;
  a.nitems = a.ctiles * a.passes * (form == FWD ? 2 : 1);
  a.slots = slots;
  if (grid > a.nitems) grid = a.nitems;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sub = s != nullptr;
  switch (form * 2 + (sub ? 1 : 0)) {
    case DENSE * 2: return (int)launch<DENSE, false>(a, grid, st);
    case DENSE * 2 + 1: return (int)launch<DENSE, true>(a, grid, st);
    case FWD * 2: return (int)launch<FWD, false>(a, grid, st);
    case INV * 2: return (int)launch<INV, false>(a, grid, st);
    case INV * 2 + 1: return (int)launch<INV, true>(a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* x_apply_manual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
