// Kernel K1: fused IC angle + rBRIEF for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sivo_tpu/ops/pallas_orb.py::_kernel.
// See sivo_tpu_torch/ops/kernel_orb.py for the semantics, the bound on
// the H100 and the design; orient_and_describe_plain there is the plain
// PyTorch version this kernel is held to.
//
// The kernel reads the float canvases and the keypoints as the pyramid
// and the selection leave them: it clamps each keypoint so its 37x37
// patch lies inside the canvas and rounds every pixel it uses to u8
// (rintf, half to even, then clamp to 0..255), so no pass over the whole
// canvas precedes it. A persistent grid of about one block per SM loads
// the pattern and the circular mask into shared memory once; its warps
// walk the keypoints, one keypoint per warp at a time.
//
// Per keypoint, lane l owns column l - 15 of the 31x31 raw patch: it
// reads that column row by row (each row one coalesced warp load, no
// index division), keeps the pixels inside the circular mask (a bit per
// row in the column's mask word, no sqrt), and sums them; the moments
// are exact integers, reduced with shuffles. The warp stages the 37x37
// blurred patch as u8 in shared memory with row loads, then lane l
// forms descriptor byte l from pattern pairs 8l .. 8l+7.
//
// Rounding follows the plain version op for op: products and sums use
// the _rn intrinsics so nvcc cannot contract them into FMAs, the norm is
// 1.0f / sqrtf (both IEEE-rounded without --use_fast_math), and rounding
// to the nearest sample is rintf (half to even, like torch.round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalf = 15;               // IC-angle patch radius
constexpr int kRaw = 2 * kHalf + 1;     // 31
constexpr int kMargin = 18;             // rBRIEF patch radius
constexpr int kBlur = 2 * kMargin + 1;  // 37
constexpr int kPitch = 40;              // row pitch of a staged patch
constexpr int kWarps = 16;              // keypoints in flight per block
constexpr int kThreads = kWarps * 32;

// torch.clamp(torch.round(p), 0, 255) as an integer
__device__ __forceinline__ int pixel_u8(float p) {
  return (int)fminf(fmaxf(rintf(p), 0.f), 255.f);
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const float* __restrict__ raw,
                    const float* __restrict__ blur,
                    const int* __restrict__ level,
                    const float2* __restrict__ xy,
                    const int* __restrict__ tables,
                    float* __restrict__ angle_out,
                    uint8_t* __restrict__ desc_out,
                    int n, int H, int W, int border) {
  __shared__ int s_pat[8][32];  // [j][l]: pattern pair 8l + j, int8 x4
  __shared__ unsigned s_col[32];
  __shared__ uint8_t s_blur[kWarps][kBlur * kPitch];

  for (int i = threadIdx.x; i < 256; i += kThreads) {
    s_pat[i & 7][i >> 3] = tables[i];
  }
  if (threadIdx.x < 32) {
    s_col[threadIdx.x] = threadIdx.x < kRaw ? (unsigned)tables[256 + threadIdx.x]
                                            : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned col_mask = s_col[lane];  // bit r: (r, lane) in the circle
  uint8_t* pb = s_blur[warp];

  for (int k = blockIdx.x * kWarps + warp; k < n; k += gridDim.x * kWarps) {
    const float2 p = xy[k];
    const int y = min(max((int)p.y + border, kMargin), H - kMargin - 1);
    const int x = min(max((int)p.x + border, kMargin), W - kMargin - 1);
    const size_t plane = (size_t)level[k] * H * W;

    __syncwarp();  // the previous keypoint's samples have been read
    const float* b0 =
        blur + plane + (size_t)(y - kMargin) * W + (x - kMargin) + lane;
#pragma unroll
    for (int r = 0; r < kBlur; ++r) {
      pb[r * kPitch + lane] = (uint8_t)pixel_u8(b0[(size_t)r * W]);
      if (lane < kBlur - 32) {
        pb[r * kPitch + 32 + lane] = (uint8_t)pixel_u8(b0[(size_t)r * W + 32]);
      }
    }

    // intensity-centroid moments over the circular mask; m10 = u * (the
    // column's sum), u = lane - 15 constant per lane
    int m01 = 0, sum = 0;
    if (lane < kRaw) {
      const float* r0 =
          raw + plane + (size_t)(y - kHalf) * W + (x - kHalf) + lane;
#pragma unroll
      for (int r = 0; r < kRaw; ++r) {
        const int pv = ((col_mask >> r) & 1u) ? pixel_u8(r0[(size_t)r * W]) : 0;
        sum += pv;
        m01 += (r - kHalf) * pv;
      }
    }
    int m10 = (lane - kHalf) * sum;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m01 += __shfl_xor_sync(0xffffffffu, m01, off);
      m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    }
    const float f01 = (float)m01;  // exact: |m| < 2^24
    const float f10 = (float)m10;
    const float nrm = __fadd_rn(__fmul_rn(f01, f01), __fmul_rn(f10, f10));
    const float rn = 1.0f / sqrtf(fmaxf(nrm, 1e-18f));
    const float ca = __fmul_rn(f10, rn);  // cos(angle)
    const float sb = __fmul_rn(f01, rn);  // sin(angle)

    __syncwarp();  // the staged patch is visible to every lane
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int w = s_pat[j][lane];
      const float x1 = (float)(int8_t)(w & 0xff);
      const float y1 = (float)(int8_t)((w >> 8) & 0xff);
      const float x2 = (float)(int8_t)((w >> 16) & 0xff);
      const float y2 = (float)(int8_t)((w >> 24) & 0xff);
      const int r1 = (int)rintf(__fadd_rn(__fmul_rn(x1, sb), __fmul_rn(y1, ca))) + kMargin;
      const int c1 = (int)rintf(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sb))) + kMargin;
      const int r2 = (int)rintf(__fadd_rn(__fmul_rn(x2, sb), __fmul_rn(y2, ca))) + kMargin;
      const int c2 = (int)rintf(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sb))) + kMargin;
      byte |= (unsigned)(pb[r1 * kPitch + c1] < pb[r2 * kPitch + c2]) << j;
    }
    desc_out[32 * (size_t)k + lane] = (uint8_t)byte;
    if (lane == 0) angle_out[k] = atan2f(f01, f10);
  }
}

}  // namespace

// raw, blur: (L, H, W) float32 canvases; level: (n,) int32; xy: (n, 2)
// float32 level coordinates (x, y) without the border, truncated toward
// zero and clamped like the plain version; tables: (288,) int32, the
// (256, 4) int8 pattern as 256 words, then the circular mask as 31
// column words (bit r set where row r of that column is inside) and one
// spare word; angle: (n,) float32; desc: (n, 32) uint8. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int sivo_orb_describe(const void* raw, const void* blur,
                                 const void* level, const void* xy,
                                 const void* tables, void* angle, void* desc,
                                 int n, int H, int W, int border,
                                 void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int needed = (n + kWarps - 1) / kWarps;
  const int blocks = needed < sms ? needed : sms;
  orb_describe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (const float*)blur, (const int*)level,
      (const float2*)xy, (const int*)tables, (float*)angle, (uint8_t*)desc,
      n, H, W, border);
  return (int)cudaGetLastError();
}
