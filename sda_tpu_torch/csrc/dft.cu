// Truncated real 2-D DFT pair for Hopper (sm_90a), f32 in, f32 out.
//
// Replaces the Pallas TPU kernels of sda_tpu/ops/pallas_dft.py:
//   rfft2_kernel  <- _rfft2_raw  (:78) -> _rfft2_kernel  (:60)
//   irfft2_kernel <- _irfft2_raw (:127) -> _irfft2_kernel (:111)
// The Pallas grid walks one batch element at a time through VMEM; here
// blocks run in parallel and each one owns an independent slice of the output.
//
// Forward, x (N, H, W) -> re, im (N, Kh, Fw):
//   stage 1 along W: re1 = x . cos_w^T, im1 = -x . sin_w^T          (H, Fw)
//   stage 2 along H: re = ch . re1 + sh . im1, im = ch . im1 - sh . re1
// Output columns f are independent in both stages, so a block owns TF of
// them for one batch element: grid (ceil(Fw / TF), N). It keeps its TF rows
// of cos_w/sin_w and its (H, TF) intermediate in shared memory (the VMEM
// intermediate of the Pallas kernel), so the intermediate never reaches
// device memory. Both stages map one warp to one row (h in stage 1, a in
// stage 2): lanes stride the contracted axis, so device-memory reads are
// coalesced and shared-memory reads are conflict-free, and a butterfly of
// shuffles sums the lanes' partial sums.
//
// Inverse, re, im (N, Kh, Fw) + Hermitian weights dw (Fw) -> x (N, H, W):
//   stage 1 along H: re1 = ch^T . re - sh^T . im, im1 = ch^T . im + sh^T . re
//   stage 2 along W: x = ((re1 dw) . cos_w - (im1 dw) . sin_w) / (H W)
// Output rows h are independent, so a block owns TH of them for one batch
// element: grid (ceil(H / TH), N). It keeps its TH columns of cos_h/sin_h and
// its (TH, Fw) intermediate, already weighted by dw, in shared memory.
// Stage 1 gives one thread one (h, f) pair, with neighbouring threads on
// neighbouring f (coalesced spectrum reads); stage 2 gives one thread one
// output column w and all TH rows (coalesced basis reads, broadcast
// shared-memory reads of the intermediate).
//
// What bounds it: the function itself needs about 2.6 MFLOP per 256^2
// field as an FFT (2.5 H W log2(H W)) and must move about 0.38 MB (field
// and truncated spectrum, f32), so its least time is set by bytes: ~0.11 us
// at 3.35 TB/s. This DFT-as-contraction design does 52.6 MFLOP per field
// (4 H W Fw + 8 Kh H Fw), 20x the FFT's count, as f32 FMAs with f32
// accumulation on the CUDA cores, not TF32 tensor cores, because the solver
// was validated at the f32 accuracy of Precision.HIGHEST.
//
// Tiles: at the solver's batch of one field the latency of each block's
// serial loop sets the time, so thin tiles (TF = 1 column with 32 warps per
// forward block, TH = 2 rows per inverse block) spread one field over 86
// and 128 blocks. At larger batches the card is full and thin tiles re-read
// the field and the bases from L2 once per column or row pair, so at 16
// fields TF = 4 (256 threads) and TH = 8 are faster. Each kernel is
// instantiated for a few tile widths; the launcher's `tile` argument picks
// one, and the Python wrapper picks it from the batch.

#include <cuda_runtime.h>

namespace {

constexpr int kInverseThreads = 256;  // stage 2 has one thread per output column

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// kTF output columns per block, kThreads threads per block.
template <int kTF, int kThreads>
__global__ void __launch_bounds__(kThreads)
rfft2_kernel(const float* __restrict__ x, const float* __restrict__ cw,
             const float* __restrict__ sw, const float* __restrict__ ch,
             const float* __restrict__ sh, float* __restrict__ re,
             float* __restrict__ im, int H, int W, int Kh, int Fw) {
  extern __shared__ float smem[];
  float* bc = smem;          // [kTF][W] cos_w rows of this tile
  float* bs = bc + kTF * W;  // [kTF][W] sin_w rows
  float* r1 = bs + kTF * W;  // [kTF][H] stage-1 real part, h contiguous
  float* i1 = r1 + kTF * H;  // [kTF][H] stage-1 imaginary part

  const int f0 = blockIdx.x * kTF;
  const int n = blockIdx.y;
  const int nf = min(kTF, Fw - f0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < kTF * W; i += blockDim.x) {
    const int f = i / W;
    const int w = i - f * W;
    const bool ok = f < nf;
    bc[i] = ok ? cw[(size_t)(f0 + f) * W + w] : 0.f;
    bs[i] = ok ? sw[(size_t)(f0 + f) * W + w] : 0.f;
  }
  __syncthreads();

  // Stage 1: one warp per row h of x.
  const float* xn = x + (size_t)n * H * W;
  for (int h = warp; h < H; h += warps) {
    float ar[kTF], ai[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) ar[f] = ai[f] = 0.f;

    const float* row = xn + (size_t)h * W;
    for (int w = lane; w < W; w += 32) {
      const float v = row[w];
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        ar[f] = fmaf(v, bc[f * W + w], ar[f]);
        ai[f] = fmaf(v, bs[f * W + w], ai[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      ar[f] = warp_sum(ar[f]);
      ai[f] = warp_sum(ai[f]);
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        r1[f * H + h] = ar[f];
        i1[f * H + h] = -ai[f];
      }
    }
  }
  __syncthreads();

  // Stage 2: one warp per output row a.
  float* ren = re + (size_t)n * Kh * Fw;
  float* imn = im + (size_t)n * Kh * Fw;
  for (int a = warp; a < Kh; a += warps) {
    float sr[kTF], si[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) sr[f] = si[f] = 0.f;

    const float* crow = ch + (size_t)a * H;
    const float* srow = sh + (size_t)a * H;
    for (int h = lane; h < H; h += 32) {
      const float c = crow[h];
      const float s = srow[h];
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        const float p = r1[f * H + h];
        const float q = i1[f * H + h];
        sr[f] = fmaf(c, p, fmaf(s, q, sr[f]));
        si[f] = fmaf(c, q, fmaf(-s, p, si[f]));
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      sr[f] = warp_sum(sr[f]);
      si[f] = warp_sum(si[f]);
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        if (f < nf) {
          ren[(size_t)a * Fw + f0 + f] = sr[f];
          imn[(size_t)a * Fw + f0 + f] = si[f];
        }
      }
    }
  }
}

// kTH output rows per block.
template <int kTH>
__global__ void __launch_bounds__(kInverseThreads)
irfft2_kernel(const float* __restrict__ re, const float* __restrict__ im,
              const float* __restrict__ cw, const float* __restrict__ sw,
              const float* __restrict__ ch, const float* __restrict__ sh,
              const float* __restrict__ dw, float* __restrict__ x, int H,
              int W, int Kh, int Fw, float scale) {
  extern __shared__ float smem[];
  float* cs = smem;           // [Kh][kTH] cos_h columns of this row tile
  float* ss = cs + Kh * kTH;  // [Kh][kTH] sin_h columns
  float* r1 = ss + Kh * kTH;  // [Fw][kTH] stage-1 real part times dw
  float* i1 = r1 + Fw * kTH;  // [Fw][kTH] stage-1 imaginary part times dw

  const int h0 = blockIdx.x * kTH;
  const int n = blockIdx.y;
  const int nh = min(kTH, H - h0);

  for (int i = threadIdx.x; i < Kh * kTH; i += blockDim.x) {
    const int a = i / kTH;
    const int j = i - a * kTH;
    const bool ok = j < nh;
    cs[i] = ok ? ch[(size_t)a * H + h0 + j] : 0.f;
    ss[i] = ok ? sh[(size_t)a * H + h0 + j] : 0.f;
  }
  __syncthreads();

  // Stage 1: one thread per (row j, column f), f fastest.
  const float* ren = re + (size_t)n * Kh * Fw;
  const float* imn = im + (size_t)n * Kh * Fw;
  for (int o = threadIdx.x; o < kTH * Fw; o += blockDim.x) {
    const int j = o / Fw;
    const int f = o - j * Fw;
    float ar = 0.f, ai = 0.f;
    for (int a = 0; a < Kh; ++a) {
      const float p = ren[(size_t)a * Fw + f];
      const float q = imn[(size_t)a * Fw + f];
      const float c = cs[a * kTH + j];
      const float s = ss[a * kTH + j];
      ar = fmaf(c, p, fmaf(-s, q, ar));
      ai = fmaf(c, q, fmaf(s, p, ai));
    }
    const float d = dw[f];
    r1[f * kTH + j] = ar * d;
    i1[f * kTH + j] = ai * d;
  }
  __syncthreads();

  // Stage 2: one thread per output column w, all kTH rows.
  float* xn = x + (size_t)n * H * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float acc[kTH];
#pragma unroll
    for (int j = 0; j < kTH; ++j) acc[j] = 0.f;

    for (int f = 0; f < Fw; ++f) {
      const float c = cw[(size_t)f * W + w];
      const float s = sw[(size_t)f * W + w];
#pragma unroll
      for (int j = 0; j < kTH; ++j) {
        acc[j] = fmaf(r1[f * kTH + j], c, fmaf(-i1[f * kTH + j], s, acc[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kTH; ++j) {
      if (j < nh) xn[(size_t)(h0 + j) * W + w] = acc[j] * scale;
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int kTF, int kThreads>
cudaError_t launch_rfft2(const float* x, const float* cw, const float* sw,
                         const float* ch, const float* sh, float* re, float* im,
                         int N, int H, int W, int Kh, int Fw,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kTF * W + 2 * kTF * H);
  cudaError_t err = allow_smem(rfft2_kernel<kTF, kThreads>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Fw + kTF - 1) / kTF, N);
  rfft2_kernel<kTF, kThreads><<<grid, kThreads, smem, stream>>>(
      x, cw, sw, ch, sh, re, im, H, W, Kh, Fw);
  return cudaGetLastError();
}

template <int kTH>
cudaError_t launch_irfft2(const float* re, const float* im, const float* cw,
                          const float* sw, const float* ch, const float* sh,
                          const float* dw, float* x, int N, int H, int W,
                          int Kh, int Fw, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * Kh * kTH + 2 * Fw * kTH);
  cudaError_t err = allow_smem(irfft2_kernel<kTH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kTH - 1) / kTH, N);
  irfft2_kernel<kTH><<<grid, kInverseThreads, smem, stream>>>(
      re, im, cw, sw, ch, sh, dw, x, H, W, Kh, Fw, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` without synchronising and
// returns cudaGetLastError() as an int (0 = launched). `tile` is the
// forward's output columns per block (1, 2, 4 or 8) or the inverse's output
// rows per block (2, 4, 8 or 16); any other value is refused.

int sda_rfft2(const float* x, const float* cw, const float* sw, const float* ch,
              const float* sh, float* re, float* im, int N, int H, int W,
              int Kh, int Fw, int tile, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 1: return (int)launch_rfft2<1, 1024>(x, cw, sw, ch, sh, re, im, N, H, W, Kh, Fw, s);
    case 2: return (int)launch_rfft2<2, 512>(x, cw, sw, ch, sh, re, im, N, H, W, Kh, Fw, s);
    case 4: return (int)launch_rfft2<4, 256>(x, cw, sw, ch, sh, re, im, N, H, W, Kh, Fw, s);
    case 8: return (int)launch_rfft2<8, 256>(x, cw, sw, ch, sh, re, im, N, H, W, Kh, Fw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int sda_irfft2(const float* re, const float* im, const float* cw,
               const float* sw, const float* ch, const float* sh,
               const float* dw, float* x, int N, int H, int W, int Kh, int Fw,
               float scale, int tile, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 2: return (int)launch_irfft2<2>(re, im, cw, sw, ch, sh, dw, x, N, H, W, Kh, Fw, scale, s);
    case 4: return (int)launch_irfft2<4>(re, im, cw, sw, ch, sh, dw, x, N, H, W, Kh, Fw, scale, s);
    case 8: return (int)launch_irfft2<8>(re, im, cw, sw, ch, sh, dw, x, N, H, W, Kh, Fw, scale, s);
    case 16: return (int)launch_irfft2<16>(re, im, cw, sw, ch, sh, dw, x, N, H, W, Kh, Fw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
