// Hopper (sm_90a) kernels of the four-step local FFT and the fused
// exchange's per-chunk callback. Plain C entry points, loaded with
// ctypes by repro_torch/kernels/fft_stage.py; each returns the
// cudaError_t of its launch (0 = launched).
//
// stage_left  replaces src/repro/kernels/fft_stage.py _stage_left_kernel
//             (stage_left, pallas_call at :106):  out[b] = (W @ A[b]) * T
// stage_right replaces src/repro/kernels/fft_stage.py _stage_right_kernel
//             (stage_right, pallas_call at :214): out[b] = A[b] @ W^T
// chunk_twiddle_pack_c64 replaces _chunk_twiddle_pack_kernel
//             (chunk_twiddle_pack_c64, pallas_call at :171):
//             out[b, j, k, t] = chunk[b, t, j] * m[k, t]
//
// The two stages are one complex GEMM template, C = L @ R (planar f32
// re/im operands, IEEE fp32 FMAs on the CUDA cores -- TF32 tensor-core
// dots miss the reference tolerances), instantiated per operand layout:
//
//   LEFT : L = W (M x K, row-major), R[k, b*N + n] = A[b, k, n].
//          The TPU kernel tiles (bm, bn) = (128, 128) clamped to N; at the
//          main path's N in {8, 32} that tile is far too narrow, so here
//          the batch is folded into the GEMM's column dimension
//          (B*N columns, read from A by stride) and the twiddle is the
//          epilogue, read as T[m, col % N].
//          Bound at the main path (W 512x512, A (4096, 512, 32)): 2.7e11
//          FLOP against 0.28 GB, so FLOPs -- 4.1 ms at the card's 67 TFLOP/s
//          fp32 peak. 4x4 register micro-tiles give 4 FMAs per shared-memory
//          load; W (2 MiB) stays in L2 across the column tiles that share it.
//   RIGHT: L = A viewed as (B*M x K), R[k, n] = W[n, k]. At the main
//          path K = N = n2 in {8, 32}: a skinny product bound by bytes
//          (A read once, out written once: 1 GiB, 0.32 ms at 3.35 TB/s).
//          The column tile is narrowed to N (128x32 or 256x16 tiles) so
//          few lanes idle.
//
// The 4-product complex form is used, not the TPU kernel's 3-matmul
// Karatsuba: its (Wr+Wi)(Ar+Ai) term loses precision, and the
// multiplies are not the bottleneck on this card.
//
// chunk_twiddle_pack is a transpose plus p complex multiplies per
// element, bound by bytes (main path: chunk (4096, 4096) c64 read, out
// (4096, 4, 4096) written: 640 MiB, 0.2 ms at 3.35 TB/s). A 32x32
// shared-memory tile makes both the chunk reads and the out writes
// coalesced; complex64 is read and written interleaved (float2), the
// layout the exchange hands over.
//
// Not yet done (later work): wgmma / TMA pipelines, double buffering.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;      // K depth of one shared-memory tile
constexpr int TM = 4;       // rows of the per-thread micro-tile
constexpr int TN = 4;       // cols of the per-thread micro-tile
constexpr int PAD = 4;      // keeps float4 alignment, spreads banks

enum Mode { LEFT = 0, RIGHT = 1 };

template <int MODE, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
complex_gemm(const float* __restrict__ lr, const float* __restrict__ li,
             const float* __restrict__ rr, const float* __restrict__ ri,
             const float* __restrict__ tr, const float* __restrict__ ti,
             float* __restrict__ outr, float* __restrict__ outi,
             long long Mg, long long Ng, int K, int N) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ __align__(16) float Ls[2][BK][BM + PAD];
  __shared__ __align__(16) float Rs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const long long tiles_m = (Mg + BM - 1) / BM;
  const long long i0 = (blockIdx.x % tiles_m) * BM;
  const long long j0 = (blockIdx.x / tiles_m) * BN;

  float acc_r[TM][TN], acc_i[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc_r[a][b] = acc_i[a][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // L tile: consecutive threads walk k within a row (coalesced reads)
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx % BK;
      const long long i = i0 + r;
      const int k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (i < Mg && k < K) {
        const long long o = i * K + k;
        vr = lr[o];
        vi = li[o];
      }
      Ls[0][kk][r] = vr;
      Ls[1][kk][r] = vi;
    }
    // R tile: consecutive threads walk the columns
    for (int idx = tid; idx < BN * BK; idx += NT) {
      const int c = idx % BN, kk = idx / BN;
      const long long j = j0 + c;
      const int k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (j < Ng && k < K) {
        long long o;
        if (MODE == LEFT) {
          const long long b = j / N, n = j - b * N;
          o = (b * K + k) * N + n;
        } else {
          o = j * K + k;
        }
        vr = rr[o];
        vi = ri[o];
      }
      Rs[0][kk][c] = vr;
      Rs[1][kk][c] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_r = *reinterpret_cast<const float4*>(&Ls[0][kk][ty * TM]);
      const float4 a_i = *reinterpret_cast<const float4*>(&Ls[1][kk][ty * TM]);
      const float4 b_r = *reinterpret_cast<const float4*>(&Rs[0][kk][tx * TN]);
      const float4 b_i = *reinterpret_cast<const float4*>(&Rs[1][kk][tx * TN]);
      const float ar[TM] = {a_r.x, a_r.y, a_r.z, a_r.w};
      const float ai[TM] = {a_i.x, a_i.y, a_i.z, a_i.w};
      const float br[TN] = {b_r.x, b_r.y, b_r.z, b_r.w};
      const float bi[TN] = {b_i.x, b_i.y, b_i.z, b_i.w};
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          acc_r[a][b] = fmaf(ar[a], br[b], acc_r[a][b]);
          acc_r[a][b] = fmaf(-ai[a], bi[b], acc_r[a][b]);
          acc_i[a][b] = fmaf(ar[a], bi[b], acc_i[a][b]);
          acc_i[a][b] = fmaf(ai[a], br[b], acc_i[a][b]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const long long i = i0 + ty * TM + a;
    if (i >= Mg) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const long long j = j0 + tx * TN + b;
      if (j >= Ng) continue;
      float re = acc_r[a][b], im = acc_i[a][b];
      long long o;
      if (MODE == LEFT) {
        const long long bb = j / N, n = j - bb * N;
        const long long t = i * N + n;
        const float t_r = tr[t], t_i = ti[t];
        const float x = re * t_r - im * t_i;
        im = re * t_i + im * t_r;
        re = x;
        o = (bb * Mg + i) * N + n;
      } else {
        o = i * Ng + j;
      }
      outr[o] = re;
      outi[o] = im;
    }
  }
}

template <int MODE, int BM, int BN>
cudaError_t launch_gemm(const float* lr, const float* li, const float* rr,
                        const float* ri, const float* tr, const float* ti,
                        float* outr, float* outi, long long Mg, long long Ng,
                        int K, int N, cudaStream_t stream) {
  const long long tiles = ((Mg + BM - 1) / BM) * ((Ng + BN - 1) / BN);
  if (tiles <= 0) return cudaSuccess;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  complex_gemm<MODE, BM, BN><<<(unsigned)tiles, (BM / TM) * (BN / TN), 0, stream>>>(
      lr, li, rr, ri, tr, ti, outr, outi, Mg, Ng, K, N);
  return cudaGetLastError();
}

__global__ void chunk_twiddle_pack(const float2* __restrict__ chunk,
                                   const float2* __restrict__ m,
                                   float2* __restrict__ out, long long B,
                                   int rows, int c, int p, long long sb,
                                   long long sr) {
  __shared__ float2 tile[32][33];
  const int t0 = blockIdx.x * 32, j0 = blockIdx.y * 32;
  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    // read chunk[b, t, j]: consecutive threads walk j (coalesced)
#pragma unroll
    for (int s = 0; s < 32; s += 8) {
      const int t = t0 + threadIdx.y + s, j = j0 + threadIdx.x;
      if (t < rows && j < c) tile[threadIdx.y + s][threadIdx.x] = chunk[b * sb + t * sr + j];
    }
    __syncthreads();
    // write out[b, j, k, t]: consecutive threads walk t (coalesced)
#pragma unroll
    for (int s = 0; s < 32; s += 8) {
      const int j = j0 + threadIdx.y + s, t = t0 + threadIdx.x;
      if (j < c && t < rows) {
        const float2 v = tile[threadIdx.x][threadIdx.y + s];
        float2* o = out + ((b * c + j) * p) * (long long)rows + t;
        for (int k = 0; k < p; ++k) {
          const float2 w = m[(long long)k * rows + t];
          o[(long long)k * rows] = make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// out[b] = (W @ A[b]) * T; w (M, K), a (B, K, N), t (M, N), out (B, M, N).
int stage_left_f32(const float* wr, const float* wi, const float* ar,
                   const float* ai, const float* tr, const float* ti,
                   float* outr, float* outi, long long B, int M, int K, int N,
                   void* stream) {
  return (int)launch_gemm<LEFT, 64, 64>(wr, wi, ar, ai, tr, ti, outr, outi, M,
                                        B * (long long)N, K, N,
                                        (cudaStream_t)stream);
}

// out[b] = A[b] @ W^T; a (B, M, K), w (N, K), out (B, M, N).
int stage_right_f32(const float* ar, const float* ai, const float* wr,
                    const float* wi, float* outr, float* outi, long long B,
                    int M, int K, int N, void* stream) {
  const long long rows = B * (long long)M;
  cudaStream_t s = (cudaStream_t)stream;
  if (N > 32)
    return (int)launch_gemm<RIGHT, 64, 64>(ar, ai, wr, wi, nullptr, nullptr, outr, outi, rows, N, K, N, s);
  if (N > 16)
    return (int)launch_gemm<RIGHT, 128, 32>(ar, ai, wr, wi, nullptr, nullptr, outr, outi, rows, N, K, N, s);
  return (int)launch_gemm<RIGHT, 256, 16>(ar, ai, wr, wi, nullptr, nullptr, outr, outi, rows, N, K, N, s);
}

// out[b, j, k, t] = chunk[b, t, j] * m[k, t]; chunk (B, rows, c) with
// element strides (sb, sr, 1), m (p, rows), out (B, c, p, rows) contiguous.
int chunk_twiddle_pack_c64(const void* chunk, const void* m, void* out,
                           long long B, int rows, int c, int p, long long sb,
                           long long sr, void* stream) {
  if (B <= 0 || rows <= 0 || c <= 0 || p <= 0) return (int)cudaSuccess;
  const dim3 block(32, 8);
  const long long gz = B < 65535 ? B : 65535;
  const dim3 grid((rows + 31) / 32, (c + 31) / 32, (unsigned)gz);
  chunk_twiddle_pack<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)chunk, (const float2*)m, (float2*)out, B, rows, c, p, sb, sr);
  return (int)cudaGetLastError();
}

const char* fft_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
