// K2 visibility raster, center sample (no MSAA): depth and triangle id.
//
// Replaces the Pallas kernel of vqengine_tpu/ops/raster.py
// (_make_raster_kernel(((0, 0),)) at :693, instantiated as
// _raster_kernel_center at :810 and launched by rasterize). Its caller is
// the shadow-map render (shadow.render_shadow_depth): every spot,
// directional and point-cube face view.
//
// What it computes. One CTA per 16x128-pixel tile streams groups of 128
// records (16 f32 each: e'0..2, dp, id, pad; pair-major rows of the
// sorted pair array) and keeps each pixel's nearest covering record
// (raster_common.cuh: stream order, tie-break and the split plane
// arithmetic, shared with K1). It writes the depth (cleared 1.0) and the
// winner's record row 12 as tri_id (-1 = none) into [H, W], the ragged
// edge masked. Bitwise equal to the plain PyTorch version
// (raster.rasterize_plain).
//
// Bound. Arithmetic: 4 planes x 9 flops (two products and two sums for
// the hi part, the same for the lo part, one add) per streamed record per
// pixel, over every record of every group a tile streams, most of which
// do not cover the pixel, against the card's fp32 rate outside the tensor
// cores. Memory traffic is small: a group's 12 plane rows once per tile,
// one id per pixel, 8 bytes of output per pixel.
// Design: K1's stream loop without the resolve. No tensor cores, no TMA
// or cp.async double-buffering: simple first.
#include "raster_common.cuh"

namespace {

using namespace vq_raster;

constexpr int REC = 16;          // floats per record
constexpr int ID_ROW = 12;

__global__ void __launch_bounds__(THREADS)
raster_vis_kernel(const float* __restrict__ pairs,
                  const float* __restrict__ gpairs,
                  const int* __restrict__ starts,
                  const int* __restrict__ rstarts,
                  const int* __restrict__ gmeta,
                  int tiles_x, int width, int height,
                  float* __restrict__ depth_out, int* __restrict__ id_out) {
  __shared__ float consts[GROUP][PLANE_CONSTS];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int lx = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * ROWS;
  float depth[ROWS];
  int win[ROWS];
  stream_tile<REC>(pairs, gpairs, starts, rstarts, gmeta, tx, ty, tiles_x,
                   consts, lx, row0, depth, win);

  const int x = tx * TILE_W + lx;
  if (x >= width) return;
  for (int i = 0; i < ROWS; ++i) {
    const int y = ty * TILE_H + row0 + i;
    if (y >= height) break;
    const long long o = (long long)y * width + x;
    depth_out[o] = depth[i];
    const int w = win[i];
    if (w == -1) {
      id_out[o] = -1;
    } else {
      const float* s = w >= 0 ? pairs + (long long)w * REC
                              : gpairs + (long long)(-2 - w) * REC;
      id_out[o] = (int)s[ID_ROW];
    }
  }
}

}  // namespace

extern "C" int vq_raster_vis(const void* pairs, const void* gpairs,
                             const void* starts, const void* rstarts,
                             const void* gmeta, int tiles_x, int tiles_y,
                             int width, int height, void* depth,
                             void* tri_id, void* stream) {
  if (tiles_x > 0 && tiles_y > 0) {
    raster_vis_kernel<<<dim3(tiles_x, tiles_y), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const float*)pairs, (const float*)gpairs, (const int*)starts,
        (const int*)rstarts, (const int*)gmeta, tiles_x, width, height,
        (float*)depth, (int*)tri_id);
  }
  return (int)cudaGetLastError();
}
