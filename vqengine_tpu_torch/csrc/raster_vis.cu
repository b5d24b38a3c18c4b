// K2 visibility raster: depth and triangle id, for the pixel center or for
// each of the 4 MSAA samples.
//
// Replaces the Pallas kernel of vqengine_tpu/ops/raster.py
// (_make_raster_kernel at :693, instantiated as _raster_kernel_center and
// _raster_kernel_msaa4 at :810-811 and launched by rasterize). The center
// variant's caller is the shadow-map render (shadow.render_shadow_depth):
// every spot, directional and point-cube face view. The MSAA variant has
// no caller on the port's render path (the reference's only caller is the
// resolve-gather branch of geometry_pass, which the port does not carry).
//
// What it computes. One CTA per 16x128-pixel tile streams groups of 128
// records (16 f32 each: e'0..2, dp, id, pad; pair-major rows of the
// sorted pair array) and keeps each pixel's nearest covering record
// (raster_common.cuh: stream order, tie-break and the split plane
// arithmetic, shared with K1). The MSAA variant adds each record's
// per-sample offsets e_x*dx + e_y*dy to the split plane values and keeps
// one depth/id carry per sample. It writes the depth (cleared 1.0) and
// the winner's record row 12 as tri_id (-1 = none) into [H, W], or
// [4, H, W] per sample, the ragged edge masked. Bitwise equal to the
// plain PyTorch version (raster.rasterize_plain).
//
// Bound. Arithmetic: 4 planes x 9 flops (two products and two sums for
// the hi part, the same for the lo part, one add) per streamed record per
// pixel (36), plus 16 offset adds per pixel in the MSAA variant (52),
// over every record of every group a tile streams, most of which do not
// cover the pixel, against the card's fp32 rate outside the tensor cores.
// Memory traffic is small: a group's 12 plane rows once per tile, one id
// per pixel and sample, 8 bytes of output per pixel and sample.
// Design: K1's stream loop without the resolve. No tensor cores, no TMA
// or cp.async double-buffering: simple first.
#include "raster_common.cuh"

namespace {

using namespace vq_raster;

constexpr int REC = 16;          // floats per record
constexpr int ID_ROW = 12;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
raster_vis_kernel(const float* __restrict__ pairs,
                  const float* __restrict__ gpairs,
                  const int* __restrict__ starts,
                  const int* __restrict__ rstarts,
                  const int* __restrict__ gmeta,
                  int tiles_x, int width, int height,
                  float* __restrict__ depth_out, int* __restrict__ id_out) {
  constexpr int K = ModeInfo<MODE>::CARRIES;
  __shared__ float consts[GROUP][ModeInfo<MODE>::NC];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int lx = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * ROWS;
  float depth[K * ROWS];
  int win[K * ROWS];
  unsigned cov = 0;
  stream_tile<REC, MODE>(pairs, gpairs, starts, rstarts, gmeta, tx, ty,
                         tiles_x, consts, lx, row0, depth, win, &cov);

  const int x = tx * TILE_W + lx;
  if (x >= width) return;
  const long long plane = (long long)width * height;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int y = ty * TILE_H + row0 + i;
      if (y >= height) break;
      const long long o = k * plane + (long long)y * width + x;
      depth_out[o] = depth[k * ROWS + i];
      const int w = win[k * ROWS + i];
      if (w == -1) {
        id_out[o] = -1;
      } else {
        const float* s = w >= 0 ? pairs + (long long)w * REC
                                : gpairs + (long long)(-2 - w) * REC;
        id_out[o] = (int)s[ID_ROW];
      }
    }
  }
}

template <int MODE>
int launch(const void* pairs, const void* gpairs, const void* starts,
           const void* rstarts, const void* gmeta, int tiles_x, int tiles_y,
           int width, int height, void* depth, void* tri_id, void* stream) {
  if (tiles_x > 0 && tiles_y > 0) {
    raster_vis_kernel<MODE><<<dim3(tiles_x, tiles_y), THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const float*)pairs, (const float*)gpairs, (const int*)starts,
        (const int*)rstarts, (const int*)gmeta, tiles_x, width, height,
        (float*)depth, (int*)tri_id);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vq_raster_vis(const void* pairs, const void* gpairs,
                             const void* starts, const void* rstarts,
                             const void* gmeta, int tiles_x, int tiles_y,
                             int width, int height, void* depth,
                             void* tri_id, void* stream) {
  return launch<CENTER>(pairs, gpairs, starts, rstarts, gmeta, tiles_x,
                        tiles_y, width, height, depth, tri_id, stream);
}

extern "C" int vq_raster_vis_msaa4(const void* pairs, const void* gpairs,
                                   const void* starts, const void* rstarts,
                                   const void* gmeta, int tiles_x,
                                   int tiles_y, int width, int height,
                                   void* depth, void* tri_id, void* stream) {
  return launch<SAMPLES4>(pairs, gpairs, starts, rstarts, gmeta, tiles_x,
                          tiles_y, width, height, depth, tri_id, stream);
}
