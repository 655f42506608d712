// Hopper (sm_90a) kernels of the four-step local FFT and the fused
// exchange's per-chunk callback. Plain C entry points, loaded with
// ctypes by repro_torch/kernels/fft_stage.py; each returns the
// cudaError_t of its launch (0 = launched). Every operand is interleaved
// complex64 (float2): no planar re/im planes.
//
// stage_left  replaces src/repro/kernels/fft_stage.py _stage_left_kernel
//             (stage_left, pallas_call at :106):  out[b] = (W @ A[b]) * T
// stage_right replaces src/repro/kernels/fft_stage.py _stage_right_kernel
//             (stage_right, pallas_call at :214): out[b] = A[b] @ W^T
// chunk_twiddle_pack_c64 replaces _chunk_twiddle_pack_kernel
//             (chunk_twiddle_pack_c64, pallas_call at :171):
//             out[b, j, k, t] = chunk[b, t, j] * m[k, t], or, in its
//             accumulate mode, out[b, j, k, t] += chunk[b, t, j] * m[k, t]
//
// Both stages are complex GEMMs on the tensor cores in 3xTF32:
// mma.sync.m16n8k8 TF32, each fp32 operand split as big = tf32(x) (round
// to nearest) and small = x - big, and three products summed in fp32,
// small terms first: a_small*b_big + a_big*b_small + a_big*b_big.
// One-pass TF32 keeps 11 significant bits (rounding error up to 4.9e-4
// per operand) and misses the reference's 2e-4 per-stage and 2e-5
// fft_last_axis tolerances (a CPU emulation at n = 16384 gives 3.6e-4).
// The split carries about 21 bits of each operand (the tensor core reads
// the top 11 of small), and the dropped small*small term is below 2^-22
// relative. What is left is the tensor core's own accumulation, which
// rounds toward zero: chained over K = 512 it drifts to ~8e-6 of the
// largest output, so each k-step's three products go into a fresh
// partial that is added to the accumulator in fp32 (round to nearest).
// That brings the stages to ~1e-6 of the largest output. Rates on the
// H100: 495 TFLOP/s TF32 dense, i.e. 165 TFLOP/s of fp32-accurate
// products, against 67 TFLOP/s fp32 on the CUDA cores.
//
// The complex product is one real GEMM over the "realified" operands.
// A 16-row A-operand tile holds 8 complex outputs: rows 0-7 their real
// parts, rows 8-15 their imaginary parts; an 8-deep k-step holds 4
// complex inputs: k 0-3 real parts, 4-7 imaginary parts. With the
// m16n8k8 fragment layout (g = lane / 4, q = lane % 4) that gives
//   A fragment = {wr, wi, -wi, wr} of W[row g][k q]   (one float2 load)
//   B fragment = {xr, xi}          of X[k q][col g]   (one float2 load)
//   D: acc[0], acc[2] = (re, im) of out[row g][col 2q], acc[1], acc[3]
//      = (re, im) of out[row g][col 2q + 1]
// so every thread's accumulators are whole complex outputs, the twiddle
// multiply happens in registers, and no thread ever sees planar data.
// The 4-product form is kept, not the TPU kernel's 3-matmul Karatsuba:
// its (Wr+Wi)(Ar+Ai) term loses precision.
//
// stage_left: out^T is not formed; W (M x K) is the A operand, the data
//   X[k, col] = A[b, k, n] with col = b*N + n (the batch folded into the
//   columns, read by stride) is the B operand, the twiddle T[m, col % N]
//   is the epilogue. Bound at the main path (W 512x512, A (4096, 512, 32)
//   or (16384, 512, 8)): 2.75e11 FLOP against 0.28 GB -- operations:
//   4.1 ms at the fp32 CUDA-core peak (67 TFLOP/s), 1.67 ms for the three
//   TF32 products at 495 TFLOP/s. Design: 64 x 128 (complex rows x
//   columns) block tiles, 8 warps of 16 x 64, a 3-stage cp.async ring of
//   16-deep k tiles in dynamic shared memory (W tile and data tile both),
//   rows padded so every fragment load is bank-conflict free; the block
//   index walks the 8 row tiles of one column tile first, so a data tile
//   is read from HBM once and W (2 MiB) stays in L2.
// stage_right: out[r, n] = sum_k A[r, k] W[n, k], rows r = b*M + m; W is
//   the A operand, the rows of A the B operand. At the main path
//   K = N = n2 in {32, 8} over 2.1 M / 8.4 M rows: 1 GiB read and written,
//   0.32 ms at 3.35 TB/s -- bytes (the FLOPs: 0.26 ms at the fp32
//   CUDA-core peak, so no CUDA-core design reaches the byte bound;
//   0.10 ms in 3xTF32). Design: a persistent grid that walks row tiles,
//   a 2-stage cp.async ring of 16-byte loads (a tile of rows is one
//   contiguous span), W split into tf32 big/small once per block and kept
//   in shared memory for the whole kernel (K <= 32; larger K streams W
//   beside the data in 32-deep chunks). It writes out transposed,
//   (B, N, M) contiguous, because that is the order fft_last_axis
//   flattens to (k1 + n1*k2): the wrapper returns the (B, M, N) view and
//   the final transpose costs nothing.
//
// chunk_twiddle_pack is a transpose plus p complex multiplies per
// element (6 FLOPs per output, 8 accumulating: ~6 us at the fp32 peak),
// so both modes are bound by bytes. At the main path (chunk (4096, 4096)
// c64, p = 4, out (4096, 4, 4096)): fresh mode reads the chunk and
// writes out, 640 MiB, 0.200 ms at 3.35 TB/s; accumulate mode -- the
// fused exchange's per-arrival sum, which before was this kernel into a
// fresh tensor and then an add_ (1.5 GiB more) -- also reads out:
// 1.13 GiB, 0.361 ms. Design:
//   - out is written along t in 16-byte runs (two complex64 a thread, a
//     warp 512 contiguous bytes of one (j, k) row), and read the same
//     way in accumulate mode, all of a thread's accumulator loads for
//     one k issued before its first store;
//   - m[k, t..t+1] is loaded once per k and used for all of the
//     thread's columns (it was re-read for every (j, k));
//   - a chunk unit-stride along j is staged through a 64 x 32 smem tile
//     (rows permuted so each thread's two rows sit 32 smem rows apart:
//     conflict-free with an odd row stride); a chunk unit-stride along t
//     (a transposed block's own chunk) is read straight along t, no
//     tile, no copy;
//   - tiles wholly inside the chunk take a body with no masks and no
//     alignment branches; <= 64 registers keep 4 blocks on an SM;
//   - any strides: the chunk's row (or column) and batch strides, out's
//     batch, column and k strides (a sub-chunk's slot of a wider
//     accumulator); a persistent loop over the batch.
// Of these, the 16-byte runs and loading m once per k made accumulate
// mode fast; fresh mode was already at ~83 % of its byte bound in the
// original 32 x 32 tile (CUDA events; PERF.md).
//
// Every kernel masks ragged M, K and columns; K is zero-padded to the
// MMA depth in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- 3xTF32 tensor-core helpers -------------------------------------------

// x = big + small: big = x rounded to tf32 (to nearest, ties away from
// zero: cvt.rna.tf32.f32, done here with two integer ops -- cvt runs at a
// quarter of the fp32 rate and would bound the kernels), small = x - big
// (exact in fp32, |small| <= 2^-11 |x|), whose low 13 bits the tensor core
// ignores.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

constexpr uint32_t SIGN = 0x80000000u;

struct AFrag {  // realified W element {wr, wi, -wi, wr}, big and small
  uint32_t big[4], small[4];
};

struct BFrag {  // data element {xr, xi}, big and small
  uint32_t big[2], small[2];
};

__device__ __forceinline__ AFrag a_frag(uint32_t rb, uint32_t ib, uint32_t rs, uint32_t is) {
  return AFrag{{rb, ib, ib ^ SIGN, rb}, {rs, is, is ^ SIGN, rs}};
}

__device__ __forceinline__ AFrag a_frag(float2 w) {
  uint32_t rb, rs, ib, is;
  split(w.x, rb, rs);
  split(w.y, ib, is);
  return a_frag(rb, ib, rs, is);
}

__device__ __forceinline__ BFrag b_frag(float2 x) {
  BFrag f;
  split(x.x, f.big[0], f.small[0]);
  split(x.y, f.big[1], f.small[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b over one 8-deep k-step: the three TF32 products, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, const BFrag& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// The tensor core rounds its sums toward zero, so a long chain of mma
// into one accumulator drifts (at K = 512, ~8e-6 relative to the largest
// output); each k-step's products go into a fresh partial that is then
// added to the accumulator in fp32 (round to nearest).
__device__ __forceinline__ void promote(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// ---- cp.async: VEC complex64 (8*VEC bytes) per copy, zero-fill when !valid

template <int VEC>
__device__ __forceinline__ void cp_async(float2* smem, const float2* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 8 * VEC : 0;
  if (VEC == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// ---- stage_left: out[b, m, n] = (sum_k W[m, k] A[b, k, n]) * T[m, n] --------

constexpr int L_BM = 64;           // complex rows (m) per block
constexpr int L_BN = 128;          // columns (b, n) per block
constexpr int L_BK = 16;           // complex k per pipeline stage
constexpr int L_STAGES = 3;
constexpr int L_THREADS = 256;     // 8 warps: 4 along m (16 rows) x 2 along columns (64)
constexpr int L_WS = L_BK + 4;     // smem row strides in float2; = 4 (mod 16) keeps the
constexpr int L_XS = L_BN + 4;     // fragment loads of a half-warp on distinct banks
constexpr int L_STAGE_ELEMS = L_BM * L_WS + L_BK * L_XS;
constexpr size_t L_SMEM = sizeof(float2) * L_STAGES * L_STAGE_ELEMS;

template <int VEC>
__global__ void __launch_bounds__(L_THREADS, 2)
stage_left_tc(const float2* __restrict__ w, const float2* __restrict__ a,
              const float2* __restrict__ t, float2* __restrict__ out,
              int M, int K, int N, long long ncols) {
  extern __shared__ __align__(16) float2 smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  const long long tiles_m = (M + L_BM - 1) / L_BM;
  const int m0 = (int)(blockIdx.x % tiles_m) * L_BM;
  const long long col0 = (long long)(blockIdx.x / tiles_m) * L_BN;

  // this thread's copies: W row wr_row, k offsets wk + step * i; data column
  // xc, k rows xk + step * i (fixed across k tiles)
  constexpr int W_PER_ROW = L_BK / VEC, W_STEP = L_THREADS / W_PER_ROW;
  constexpr int X_PER_ROW = L_BN / VEC, X_STEP = L_THREADS / X_PER_ROW;
  const int w_row = tid / W_PER_ROW, w_k = (tid % W_PER_ROW) * VEC;
  const int x_k = tid / X_PER_ROW, x_c = (tid % X_PER_ROW) * VEC;
  const long long col = col0 + x_c;
  const bool col_ok = col < ncols;
  long long x_base = 0;
  if (col_ok) {
    const long long b = col / N, n = col - b * N;
    x_base = b * K * (long long)N + n;
  }

  auto load = [&](int kt, int stage) {
    float2* ws = smem + stage * L_STAGE_ELEMS;
    float2* xs = ws + L_BM * L_WS;
    const int k0 = kt * L_BK;
#pragma unroll
    for (int r = w_row; r < L_BM; r += W_STEP) {
      const int m = m0 + r, k = k0 + w_k;
      const bool ok = m < M && k < K;
      cp_async<VEC>(ws + r * L_WS + w_k, ok ? w + (long long)m * K + k : w, ok);
    }
#pragma unroll
    for (int kk = x_k; kk < L_BK; kk += X_STEP) {
      const int k = k0 + kk;
      const bool ok = col_ok && k < K;
      cp_async<VEC>(xs + kk * L_XS + x_c, ok ? a + x_base + (long long)k * N : a, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + L_BK - 1) / L_BK;
#pragma unroll
  for (int s = 0; s < L_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<L_STAGES - 2>();
    __syncthreads();  // tile kt landed for all threads; tile kt-1's buffer is free
    if (kt + L_STAGES - 1 < nk) load(kt + L_STAGES - 1, (kt + L_STAGES - 1) % L_STAGES);
    cp_commit();

    const float2* ws = smem + (kt % L_STAGES) * L_STAGE_ELEMS;
    const float2* xs = ws + L_BM * L_WS;
#pragma unroll
    for (int ks = 0; ks < L_BK; ks += 4) {
      AFrag af[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) af[mt] = a_frag(ws[(wm + mt * 8 + g) * L_WS + ks + q]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const BFrag bf = b_frag(xs[(ks + q) * L_XS + wn + nt * 8 + g]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float d[4] = {};
          mma3(d, af[mt], bf);
          promote(acc[mt][nt], d);
        }
      }
    }
  }
  cp_wait<0>();

  // epilogue: twiddle in registers, complex64 stores
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = m0 + wm + mt * 8 + g;
    if (m >= M) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long c = col0 + wn + nt * 8 + 2 * q + j;
        if (c >= ncols) continue;
        const long long b = c / N, n = c - b * N;
        const float2 v = make_float2(acc[mt][nt][j], acc[mt][nt][j + 2]);
        out[(b * M + m) * N + n] = cmul(v, t[(long long)m * N + n]);
      }
    }
  }
}

// ---- stage_right: out[b, n, m] = sum_k A[b, m, k] W[n, k] (written transposed)

constexpr int R_KC = 32;           // complex k per chunk (the main path's K fits in one)
constexpr int R_STAGES = 2;        // ring depth: one item in flight while one computes
constexpr int R_THREADS = 256;     // 8 warps, each 8*RW rows x all 8*WT outputs

__host__ __device__ constexpr int r_stride(int kcols) { return (kcols + 7) / 8 * 8 + 4; }  // = 4 (mod 8)

template <int WT, int RW>
__host__ __device__ constexpr size_t r_smem(int kcols, int wslots) {
  return sizeof(float2) * R_STAGES * (8 * 8 * RW) * r_stride(kcols) +
         sizeof(float4) * wslots * (8 * WT) * r_stride(kcols);
}

template <int WT, int RW, int VEC>
__global__ void __launch_bounds__(R_THREADS)
stage_right_tc(const float2* __restrict__ a, const float2* __restrict__ w,
               float2* __restrict__ out, long long rows, int M, int K, int N) {
  constexpr int TR = 8 * 8 * RW;  // rows per tile
  constexpr int NB = 8 * WT;      // outputs per block
  extern __shared__ __align__(16) float2 smem[];
  const int kmax = K < R_KC ? K : R_KC;
  const int S = r_stride(kmax);
  const int nkc = (K + R_KC - 1) / R_KC;
  float2* xs_base = smem;                                                   // [R_STAGES][TR][S]
  float4* ws_base = reinterpret_cast<float4*>(smem + R_STAGES * TR * S);    // [wslots][NB][S]
  // W stays in one slot for the whole kernel when K fits one chunk, else
  // it streams beside the data, one slot per ring stage
  auto wslot = [&](long long j) { return nkc > 1 ? (int)(j % R_STAGES) : 0; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.y * NB;
  const long long tiles = (rows + TR - 1) / TR;

  // item j of this block: row tile blockIdx.x + (j / nkc) * gridDim.x, k chunk j % nkc
  auto tile_of = [&](long long j) { return blockIdx.x + (j / nkc) * (long long)gridDim.x; };
  auto kcols_of = [&](int k0) { const int kn = K - k0 < R_KC ? K - k0 : R_KC; return (kn + 3) & ~3; };

  auto load = [&](long long j) {
    const long long r0 = tile_of(j) * TR;
    const int k0 = (int)(j % nkc) * R_KC, kcols = kcols_of(k0);
    float2* xs = xs_base + (int)(j % R_STAGES) * TR * S;
    const int per_row = kcols / VEC;
    for (int c = tid; c < TR * per_row; c += R_THREADS) {
      const int r = c / per_row, kk = (c - r * per_row) * VEC;
      const long long row = r0 + r;
      const int k = k0 + kk;
      const bool ok = row < rows && k < K;
      cp_async<VEC>(xs + r * S + kk, ok ? a + row * K + k : a, ok);
    }
    if (nkc > 1 || j == 0) {  // W, split once into tf32 (big.re, big.im, small.re, small.im)
      float4* ws = ws_base + wslot(j) * NB * S;
      for (int e = tid; e < NB * kcols; e += R_THREADS) {
        const int i = e / kcols, kk = e - i * kcols;
        const int n = n0 + i, k = k0 + kk;
        const float2 v = (n < N && k < K) ? w[(long long)n * K + k] : make_float2(0.f, 0.f);
        uint32_t rb, rs, ib, is;
        split(v.x, rb, rs);
        split(v.y, ib, is);
        ws[i * S + kk] = make_float4(__uint_as_float(rb), __uint_as_float(ib),
                                     __uint_as_float(rs), __uint_as_float(is));
      }
    }
  };

  if ((long long)blockIdx.x >= tiles) return;
#pragma unroll
  for (int s = 0; s < R_STAGES - 1; ++s) {
    if (tile_of(s) < tiles) load(s);
    cp_commit();
  }
  float acc[WT][RW][4];
  for (long long j = 0;; ++j) {
    const long long tile = tile_of(j);
    if (tile >= tiles) break;
    cp_wait<R_STAGES - 2>();
    __syncthreads();  // item j landed for all threads; item j-1's buffers are free
    if (tile_of(j + R_STAGES - 1) < tiles) load(j + R_STAGES - 1);
    cp_commit();

    const int kc = (int)(j % nkc);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < WT; ++i)
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][r][e] = 0.f;
    }
    const float2* xs = xs_base + (int)(j % R_STAGES) * TR * S + (warp * 8 * RW + g) * S + q;
    const float4* ws = ws_base + wslot(j) * NB * S + g * S + q;
    const int kcols = kcols_of(kc * R_KC);
    for (int ks = 0; ks < kcols; ks += 4) {
      BFrag bf[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) bf[r] = b_frag(xs[r * 8 * S + ks]);
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const float4 v = ws[i * 8 * S + ks];
        const AFrag af = a_frag(__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                                __float_as_uint(v.w));
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float d[4] = {};
          mma3(d, af, bf[r]);
          promote(acc[i][r], d);
        }
      }
    }

    if (kc == nkc - 1) {
      const long long r0 = tile * TR + warp * 8 * RW;
#pragma unroll
      for (int i = 0; i < WT; ++i) {
        const int n = n0 + i * 8 + g;
        if (n >= N) continue;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const long long row = r0 + r * 8 + 2 * q;
          if (row >= rows) continue;
          const long long b = row / M, m = row - b * M;
          float2* o = out + (b * N + n) * M + m;
          if ((M & 1) == 0) {  // rows 2q, 2q+1 share b and land side by side, 16-byte aligned
            *reinterpret_cast<float4*>(o) = make_float4(acc[i][r][0], acc[i][r][2], acc[i][r][1], acc[i][r][3]);
          } else {
            o[0] = make_float2(acc[i][r][0], acc[i][r][2]);
            if (row + 1 < rows) {
              const long long b1 = (row + 1) / M, m1 = row + 1 - b1 * M;
              out[(b1 * N + n) * M + m1] = make_float2(acc[i][r][1], acc[i][r][3]);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();
}

template <int WT, int RW, int VEC>
cudaError_t launch_right(const float2* a, const float2* w, float2* out, long long rows, int M,
                         int K, int N, cudaStream_t stream) {
  auto kernel = stage_right_tc<WT, RW, VEC>;
  const int kmax = K < R_KC ? K : R_KC;
  const size_t smem = r_smem<WT, RW>(kmax, K > R_KC ? R_STAGES : 1);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, R_THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (rows + 8 * 8 * RW - 1) / (8 * 8 * RW);
  const long long fill = (long long)per_sm * sms;
  const unsigned gx = (unsigned)(tiles < fill ? tiles : fill);
  const unsigned gy = (unsigned)((N + 8 * WT - 1) / (8 * WT));
  if (gy > 65535u) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(gx, gy), R_THREADS, smem, stream>>>(a, w, out, rows, M, K, N);
  return cudaGetLastError();
}

template <int WT, int RW>
cudaError_t launch_right(const float2* a, const float2* w, float2* out, long long rows, int M,
                         int K, int N, bool vec2, cudaStream_t stream) {
  return vec2 ? launch_right<WT, RW, 2>(a, w, out, rows, M, K, N, stream)
              : launch_right<WT, RW, 1>(a, w, out, rows, M, K, N, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- chunk_twiddle_pack ------------------------------------------------------
//
// out[b, j, k, t] (+)= chunk[b, t, j] * m[k, t]. A block owns a tile of
// PACK_T = 64 rows t by PACK_J = 32 columns j of one batch entry; lane l
// of warp w takes the two adjacent rows t0 + 2l, t0 + 2l + 1 and the
// PACK_JPT columns j0 + w + 8i. Each thread's stores run along t, so a
// warp writes 512 contiguous bytes of one (j, k) row, one 16-byte store a
// thread.

constexpr int PACK_THREADS = 256;
constexpr int PACK_WARPS = PACK_THREADS / 32;  // warps, side by side along j
constexpr int PACK_JPT = 4;                    // columns a thread
constexpr int PACK_T = 64;                     // rows t of a tile, two a lane
constexpr int PACK_J = PACK_WARPS * PACK_JPT;  // columns j of a tile
constexpr int PACK_S = PACK_J + 1;  // odd smem row stride: a warp's column reads hit 32 banks

struct Run {  // two adjacent complex64 values along t
  float2 e[2];
};

// p[0..2) (n of them valid): one 16-byte access where vec says p is
// 16-byte aligned, element by element otherwise
__device__ __forceinline__ Run load_run(const float2* p, int n, bool vec) {
  Run r;
  if (vec && n >= 2) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.e[0] = make_float2(q.x, q.y);
    r.e[1] = make_float2(q.z, q.w);
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) r.e[s] = s < n ? p[s] : make_float2(0.f, 0.f);
  }
  return r;
}

__device__ __forceinline__ void store_run(float2* p, const Run& r, int n, bool vec) {
  if (vec && n >= 2) {
    *reinterpret_cast<float4*>(p) = make_float4(r.e[0].x, r.e[0].y, r.e[1].x, r.e[1].y);
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (s < n) p[s] = r.e[s];
  }
}

// One batch entry of one tile. FULL: the tile lies wholly inside the
// chunk and every run is 16-byte aligned, so the body has no masks and no
// alignment branches (the edge tiles take FULL = false).
template <bool ACC, bool ROWS, bool FULL>
__device__ __forceinline__ void pack_tile(const float2* __restrict__ chunk, const float2* __restrict__ m,
                                          float2* __restrict__ o, float2* tile, int rows, int c, int p,
                                          long long cs, long long oj, long long ok, int t0, int jt,
                                          bool vec_in, bool vec_m, bool vec_out) {
  const int warp = threadIdx.x >> 5, u = threadIdx.x & 31;
  const int t = t0 + 2 * u, j0 = jt + warp;  // this thread's first row and column
  const int nt = FULL ? 2 : rows - t;
  const bool vi = FULL || vec_in, vm = FULL || vec_m, vo = FULL || vec_out;
  auto n_at = [&](int j) { return FULL || j < c ? nt : 0; };
  Run v[PACK_JPT];
  if (ROWS) {  // chunk[:, j] is unit-stride along t: read straight, no transpose
#pragma unroll
    for (int i = 0; i < PACK_JPT; ++i) {
      const int j = j0 + PACK_WARPS * i;
      v[i] = load_run(chunk + j * cs + t, n_at(j), vi);
    }
  } else {
    // stage chunk[t0:t0+T, j-tile] reading along j (coalesced); tile row
    // tl lands in smem row (tl % 2)*(T/2) + tl/2, so this thread's two
    // rows are smem rows u and u + T/2
    for (int e = threadIdx.x; e < PACK_T * PACK_J; e += PACK_THREADS) {
      const int tl = e / PACK_J, jl = e - tl * PACK_J, tt = t0 + tl, j = jt + jl;
      tile[((tl % 2) * (PACK_T / 2) + tl / 2) * PACK_S + jl] =
          FULL || (tt < rows && j < c) ? chunk[tt * cs + j] : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PACK_JPT; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s) v[i].e[s] = tile[(s * (PACK_T / 2) + u) * PACK_S + warp + PACK_WARPS * i];
    __syncthreads();  // the tile is free for the next batch entry
  }
  if (nt <= 0) return;
  o += t;
  // m[k, t..t+2) once per k; in ACC mode every accumulator load of the k
  // is issued before the first multiply
  for (int k = 0; k < p; ++k) {
    const Run w = load_run(m + (long long)k * rows + t, nt, vm);
    Run r[PACK_JPT];
#pragma unroll
    for (int i = 0; i < PACK_JPT; ++i) {
      const int j = j0 + PACK_WARPS * i;
      if (ACC) r[i] = load_run(o + j * oj + k * ok, n_at(j), vo);
    }
#pragma unroll
    for (int i = 0; i < PACK_JPT; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float2 x = cmul(v[i].e[s], w.e[s]);
        r[i].e[s] = ACC ? make_float2(r[i].e[s].x + x.x, r[i].e[s].y + x.y) : x;
      }
#pragma unroll
    for (int i = 0; i < PACK_JPT; ++i) {
      const int j = j0 + PACK_WARPS * i;
      if (FULL || j < c) store_run(o + j * oj + k * ok, r[i], nt, vo);
    }
  }
}

// flags: bit 0 the chunk's runs along t are 16-byte aligned (ROWS only),
// bit 1 m's, bit 2 out's. Four blocks an SM: at most 64 registers.
template <bool ACC, bool ROWS>
__global__ void __launch_bounds__(PACK_THREADS, 4)
chunk_twiddle_pack(const float2* __restrict__ chunk, const float2* __restrict__ m,
                   float2* __restrict__ out, long long B, int rows, int c, int p,
                   long long cb, long long cs, long long ob, long long oj, long long ok, int flags) {
  __shared__ float2 tile[ROWS ? 1 : PACK_T * PACK_S];
  const bool vec_in = flags & 1, vec_m = flags & 2, vec_out = flags & 4;
  const int t0 = blockIdx.x * PACK_T, jt = blockIdx.y * PACK_J;
  const bool full = t0 + PACK_T <= rows && jt + PACK_J <= c && vec_m && vec_out && (vec_in || !ROWS);
  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    if (full)
      pack_tile<ACC, ROWS, true>(chunk + b * cb, m, out + b * ob, tile, rows, c, p, cs, oj, ok, t0, jt,
                                 vec_in, vec_m, vec_out);
    else
      pack_tile<ACC, ROWS, false>(chunk + b * cb, m, out + b * ob, tile, rows, c, p, cs, oj, ok, t0, jt,
                                  vec_in, vec_m, vec_out);
  }
}

struct PackArgs {
  const float2* chunk;
  const float2* m;
  float2* out;
  long long B;
  int rows, c, p;
  long long cb, cs, ob, oj, ok;
};

template <bool ACC, bool ROWS>
cudaError_t launch_pack(const PackArgs& a, cudaStream_t stream) {
  const long long gx = (a.rows + PACK_T - 1) / PACK_T, gy = (a.c + PACK_J - 1) / PACK_J;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const unsigned gz = (unsigned)(a.B < 65535 ? a.B : 65535);
  // 16-byte runs need even strides along the run's neighbours and aligned bases
  const bool even_m = a.rows % 2 == 0, even_in = a.cb % 2 == 0 && a.cs % 2 == 0;
  const bool even_out = a.ob % 2 == 0 && a.oj % 2 == 0 && a.ok % 2 == 0;
  const int flags = (ROWS && even_in && aligned16(a.chunk) ? 1 : 0) | (even_m && aligned16(a.m) ? 2 : 0) |
                    (even_out && aligned16(a.out) ? 4 : 0);
  chunk_twiddle_pack<ACC, ROWS><<<dim3((unsigned)gx, (unsigned)gy, gz), PACK_THREADS, 0, stream>>>(
      a.chunk, a.m, a.out, a.B, a.rows, a.c, a.p, a.cb, a.cs, a.ob, a.oj, a.ok, flags);
  return cudaGetLastError();
}

template <bool ROWS>
cudaError_t launch_pack(const PackArgs& a, bool acc, cudaStream_t stream) {
  return acc ? launch_pack<true, ROWS>(a, stream) : launch_pack<false, ROWS>(a, stream);
}

}  // namespace

extern "C" {

// out[b] = (W @ A[b]) * T; w (M, K), a (B, K, N), t (M, N), out (B, M, N),
// all complex64, contiguous.
int stage_left_c64(const void* w, const void* a, const void* t, void* out, long long B, int M,
                   int K, int N, void* stream) {
  const long long ncols = B * (long long)N;
  if (ncols <= 0 || M <= 0) return (int)cudaSuccess;
  const long long tiles = ((M + L_BM - 1) / L_BM) * ((ncols + L_BN - 1) / L_BN);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const bool vec2 = K % 2 == 0 && N % 2 == 0 && aligned16(w) && aligned16(a);
  auto kernel = vec2 ? stage_left_tc<2> : stage_left_tc<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, L_THREADS, L_SMEM, (cudaStream_t)stream>>>(
      (const float2*)w, (const float2*)a, (const float2*)t, (float2*)out, M, K, N, ncols);
  return (int)cudaGetLastError();
}

// out[b, n, m] = sum_k a[b, m, k] w[n, k]; a (B, M, K), w (N, K), out (B, N, M),
// all complex64, contiguous: the transpose of A[b] @ W^T.
int stage_right_c64(const void* a, const void* w, void* out, long long B, int M, int K, int N,
                    void* stream) {
  const long long rows = B * (long long)M;
  if (rows <= 0 || N <= 0) return (int)cudaSuccess;
  const bool vec2 = K % 2 == 0 && aligned16(a) && aligned16(out);
  const auto* ap = (const float2*)a;
  const auto* wp = (const float2*)w;
  auto* op = (float2*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0) return (int)cudaMemsetAsync(out, 0, sizeof(float2) * rows * N, s);
  if (M % 2 == 0 && !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (N <= 8) return (int)launch_right<1, 4>(ap, wp, op, rows, M, K, N, vec2, s);
  if (N <= 16) return (int)launch_right<2, 2>(ap, wp, op, rows, M, K, N, vec2, s);
  return (int)launch_right<4, 2>(ap, wp, op, rows, M, K, N, vec2, s);
}

// out[b, j, k, t] (+)= chunk[b, t, j] * m[k, t], complex64: chunk (B, rows, c)
// with batch stride cb and, along its non-unit axis, stride cs -- the row
// stride when its columns are unit-stride (rows_unit = 0), the column
// stride when its rows are (rows_unit = 1); m (p, rows) contiguous; out
// (B, c, p, rows) with element strides (ob, oj, ok, 1). accumulate = 0
// writes out, 1 adds to it.
int chunk_twiddle_pack_c64(const void* chunk, const void* m, void* out, int accumulate, int rows_unit,
                           long long B, int rows, int c, int p, long long cb, long long cs, long long ob,
                           long long oj, long long ok, void* stream) {
  if (B <= 0 || rows <= 0 || c <= 0 || p <= 0) return (int)cudaSuccess;
  const PackArgs a{(const float2*)chunk, (const float2*)m, (float2*)out, B, rows, c, p, cb, cs, ob, oj, ok};
  const bool acc = accumulate != 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(rows_unit ? launch_pack<true>(a, acc, s) : launch_pack<false>(a, acc, s));
}

const char* fft_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
