// K1 G-buffer raster in its non-MSAA and MSAA 4x variants, each unbounded
// and depth-bounded.
//
// Replaces the Pallas kernel of vqengine_tpu/ops/raster.py
// (_make_gbuf_kernel(sample_offsets, bounded) for sample_offsets None and
// MSAA4_OFFSETS, bounded False and True, built by _get_gbuf_kernel and
// launched by rasterize_gbuf). The bounded variants are the depth-peeling
// primitive of the transparent pass (two launches per frame, center
// sampled) and the alpha-mask peel: only fragments with zlo < z < zhi
// compete, zlo/zhi being two [H, W] f32 images (the reference tiles them
// edge-padded; here each thread reads its 8 pixels' window once per tile,
// row and column clamped to the frame, which is the same value).
//
// What it computes. One CTA per 16x128-pixel tile streams groups of 128
// records (32 f32 each, pair-major rows of the sorted pair array) and
// keeps each pixel's winner (raster_common.cuh: stream order, tie-break,
// the split plane arithmetic and, for MSAA, the per-sample thresholds,
// the depth key z / z + 1 / 4 and the sticky coverage bits). After the
// stream the MSAA variant turns the key back into a depth (key < 1 stays,
// key < 3 loses the + 1, the clear value 4 becomes 1). Each pixel then
// reads its winner's rows 0-29 from global memory and resolves, at the
// pixel center, perspective barycentrics, the bf16-packed normal/tangent
// pairs and uv, and the material, object and item ids, writing depth,
// tri_id and 16 G-buffer channels straight into [H, W] and [16, H, W]
// (ragged edge masked, background zeroed), and with MSAA the coverage
// [4, H, W] in {0, 1}. The resolve rounds two multiply-adds as one
// (fma_f64), as the reference does on the CPU, where its compiler
// contracts them.
//
// Bound. Arithmetic: 4 planes x 9 flops per record per pixel (36), over
// every record of every group a tile streams (most of them do not cover
// the pixel); the MSAA variant adds 12 threshold compares and the z + 1
// (52 with the key's own thresholds); the bounded variants add the two
// window compares (38 and 54). Memory traffic is small (a group's 12
// plane rows once per tile, the winner's 30 rows once per pixel, the
// window's 8 bytes per pixel, the outputs once).
// Design: the shared tile stream, then the resolve in registers. No
// tensor cores, no TMA: simple first.
#include "raster_common.cuh"

namespace {

using namespace vq_raster;

constexpr int REC = 32;          // floats per record
constexpr int GBUF_OUT = 16;
constexpr float NRM_PACK_BIAS = 3.0f;

template <int MODE, bool BOUNDED>
__global__ void __launch_bounds__(THREADS)
raster_gbuf_kernel(const float* __restrict__ pairs,
                   const float* __restrict__ gpairs,
                   const int* __restrict__ starts,
                   const int* __restrict__ rstarts,
                   const int* __restrict__ gmeta,
                   int tiles_x, int width, int height,
                   const float* __restrict__ zlo_img,
                   const float* __restrict__ zhi_img,
                   float* __restrict__ depth_out, int* __restrict__ id_out,
                   float* __restrict__ gbuf_out, float* __restrict__ cov_out) {
  __shared__ float consts[GROUP][ModeInfo<MODE>::NC];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int lx = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * ROWS;
  const float x0 = (float)(tx * TILE_W);
  const float y0 = (float)(ty * TILE_H);
  float depth[ROWS];
  int win[ROWS];
  unsigned cov = 0;
  float zlo[ROWS], zhi[ROWS];
  if constexpr (BOUNDED) {
    // the reference edge-pads the window into the padded tiles; those
    // pixels are cropped, so a clamped read is exact
    const long long xc = min(tx * TILE_W + lx, width - 1);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long o =
          (long long)min(ty * TILE_H + row0 + i, height - 1) * width + xc;
      zlo[i] = zlo_img[o];
      zhi[i] = zhi_img[o];
    }
  }
  stream_tile<REC, MODE, BOUNDED>(pairs, gpairs, starts, rstarts, gmeta, tx,
                                  ty, tiles_x, consts, lx, row0, depth, win,
                                  &cov, zlo, zhi);

  const int x = tx * TILE_W + lx;
  if (x >= width) return;
  const long long plane = (long long)width * height;
  const float px = __fadd_rn(__fadd_rn((float)lx, x0), 0.5f);
  for (int i = 0; i < ROWS; ++i) {
    const int y = ty * TILE_H + row0 + i;
    if (y >= height) break;
    const long long o = (long long)y * width + x;
    float d = depth[i];
    if constexpr (MODE == COVERAGE) {
      d = d < 1.0f ? d : d < 3.0f ? __fsub_rn(d, 1.0f) : 1.0f;
      for (int s = 0; s < NS; ++s)
        cov_out[s * plane + o] = (cov >> (NS * i + s)) & 1u ? 1.0f : 0.0f;
    }
    depth_out[o] = d;
    const int w = win[i];
    if (w == -1) {
      id_out[o] = -1;
      for (int ch = 0; ch < GBUF_OUT; ++ch) gbuf_out[ch * plane + o] = 0.0f;
      continue;
    }
    const float* s = w >= 0 ? pairs + (long long)w * REC
                            : gpairs + (long long)(-2 - w) * REC;
    const float py = __fadd_rn(__fadd_rn((float)(row0 + i), y0), 0.5f);
    float l[3];
    for (int k = 0; k < 3; ++k) {
      const float b = __fadd_rn(fma_f64(s[3 * k], px, __fmul_rn(s[3 * k + 1], py)),
                                s[3 * k + 2]);
      l[k] = b < 0.0f ? 0.0f : b;
    }
    float lsum = __fadd_rn(__fadd_rn(l[0], l[1]), l[2]);
    lsum = lsum < 1e-30f ? 1e-30f : lsum;
    for (int k = 0; k < 3; ++k) l[k] = __fdiv_rn(l[k], lsum);

    // per-corner attributes: nrm(3) tan(3) uv(2)
    float a[3][8];
    for (int v = 0; v < 3; ++v) {
      const float* av = s + 13 + 5 * v;
      for (int k = 0; k < 3; ++k) {
        const unsigned pw = __float_as_uint(av[k]);
        a[v][k] = __fsub_rn(__uint_as_float(pw & 0xFFFF0000u), NRM_PACK_BIAS);
        a[v][3 + k] = __uint_as_float(pw << 16);
      }
      a[v][6] = av[3];
      a[v][7] = av[4];
    }
    for (int ch = 0; ch < 8; ++ch) {
      const float val = fma_f64(a[2][ch], l[2],
                                __fadd_rn(__fmul_rn(a[0][ch], l[0]),
                                          __fmul_rn(a[1][ch], l[1])));
      gbuf_out[ch * plane + o] = val;
    }
    const int mi = (int)s[28];
    gbuf_out[8 * plane + o] = (float)(mi >> 16);
    gbuf_out[9 * plane + o] = s[29];
    gbuf_out[10 * plane + o] = (float)(mi & 0xFFFF);
    for (int ch = 11; ch < GBUF_OUT; ++ch) gbuf_out[ch * plane + o] = 0.0f;
    id_out[o] = (int)s[12];
  }
}

template <int MODE, bool BOUNDED>
int launch(const void* pairs, const void* gpairs, const void* starts,
           const void* rstarts, const void* gmeta, int tiles_x, int tiles_y,
           int width, int height, const void* zlo, const void* zhi,
           void* depth, void* tri_id, void* gbuf, void* cov, void* stream) {
  if (tiles_x > 0 && tiles_y > 0) {
    raster_gbuf_kernel<MODE, BOUNDED><<<dim3(tiles_x, tiles_y), THREADS, 0,
                                        (cudaStream_t)stream>>>(
        (const float*)pairs, (const float*)gpairs, (const int*)starts,
        (const int*)rstarts, (const int*)gmeta, tiles_x, width, height,
        (const float*)zlo, (const float*)zhi, (float*)depth, (int*)tri_id,
        (float*)gbuf, (float*)cov);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vq_raster_gbuf(const void* pairs, const void* gpairs,
                              const void* starts, const void* rstarts,
                              const void* gmeta, int tiles_x, int tiles_y,
                              int width, int height, void* depth,
                              void* tri_id, void* gbuf, void* stream) {
  return launch<CENTER, false>(pairs, gpairs, starts, rstarts, gmeta,
                               tiles_x, tiles_y, width, height, nullptr,
                               nullptr, depth, tri_id, gbuf, nullptr, stream);
}

extern "C" int vq_raster_gbuf_msaa(const void* pairs, const void* gpairs,
                                   const void* starts, const void* rstarts,
                                   const void* gmeta, int tiles_x,
                                   int tiles_y, int width, int height,
                                   void* depth, void* tri_id, void* gbuf,
                                   void* cov, void* stream) {
  return launch<COVERAGE, false>(pairs, gpairs, starts, rstarts, gmeta,
                                 tiles_x, tiles_y, width, height, nullptr,
                                 nullptr, depth, tri_id, gbuf, cov, stream);
}

extern "C" int vq_raster_gbuf_bounded(const void* pairs, const void* gpairs,
                                      const void* starts, const void* rstarts,
                                      const void* gmeta, int tiles_x,
                                      int tiles_y, int width, int height,
                                      const void* zlo, const void* zhi,
                                      void* depth, void* tri_id, void* gbuf,
                                      void* stream) {
  return launch<CENTER, true>(pairs, gpairs, starts, rstarts, gmeta, tiles_x,
                              tiles_y, width, height, zlo, zhi, depth, tri_id,
                              gbuf, nullptr, stream);
}

extern "C" int vq_raster_gbuf_msaa_bounded(
    const void* pairs, const void* gpairs, const void* starts,
    const void* rstarts, const void* gmeta, int tiles_x, int tiles_y,
    int width, int height, const void* zlo, const void* zhi, void* depth,
    void* tri_id, void* gbuf, void* cov, void* stream) {
  return launch<COVERAGE, true>(pairs, gpairs, starts, rstarts, gmeta,
                                tiles_x, tiles_y, width, height, zlo, zhi,
                                depth, tri_id, gbuf, cov, stream);
}
