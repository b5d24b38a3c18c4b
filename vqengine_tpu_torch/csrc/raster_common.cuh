// The tile stream shared by the two raster kernels: K1 (raster_gbuf.cu,
// 32-float records) and K2 (raster_vis.cu, 16-float records).
//
// One CTA of 256 threads owns one 16x128-pixel tile; each thread owns 8
// pixels (one column, eight rows). The tile streams groups of 128 records
// in the reference's order (global tier, tile-row tier, tile tier, each
// segment rounded out to whole groups by the caller) and keeps, per pixel,
// the nearest covering record: a pixel is covered when b0, b1, b2 >= 0 and
// z >= 0, and a covered candidate wins only if z < depth strictly (depth
// cleared to 1.0), so the first minimum in stream order wins, exactly as
// the reference's per-group argmin followed by a strict compare.
//
// Plane arithmetic. The reference's split evaluation (_plane_eval_dots in
// vqengine_tpu/ops/raster.py) is mirrored operation for operation: per
// record and tile, the plane constants (ex/2, ey/2, ew + ex*x0 + ey*y0
// [+ 2^-15 edge bias]) are split into bf16 hi and lo parts (round to
// nearest even), and a pixel's value is ((hx*X + hy*Y) + hw) +
// ((lx*X + ly*Y) + lw) with X = 2*lx+1 and Y = 2*ly+1 tile-local. Each
// product is exact in f32; every operation is an explicit _rn intrinsic
// and the library is built with -fmad=false, so the result is bitwise
// equal to the plain PyTorch version.
//
// The plane constants of a group are computed once per tile by all 256
// threads (each one record and two planes) into 12 KB of shared memory;
// then every thread walks the 128 records for its 8 pixels, with the
// column-dependent products hoisted out of the row loop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vq_raster {

constexpr int TILE_W = 128;
constexpr int TILE_H = 16;
constexpr int GROUP = 128;
constexpr int THREADS = 256;
constexpr int ROWS = TILE_H * TILE_W / THREADS;   // pixels per thread
constexpr int PLANE_CONSTS = 24;                  // 4 planes x (hi, lo) x 3
constexpr float EDGE_BIAS = 3.0517578125e-05f;    // 2^-15

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stream groups [g0, g1) of `src` (records of REC floats). Winners from
// the global tier are encoded as -2 - row, from the pair array as row
// (>= 0); -1 = none.
template <int REC>
__device__ __forceinline__ void stream_groups(
    const float* __restrict__ src, int g0, int g1, bool global_tier,
    float x0, float y0, float (*consts)[PLANE_CONSTS], int lx, int row0,
    float* depth, int* win) {
  const int t = threadIdx.x;
  const float X = (float)(2 * lx + 1);
  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // the previous group's constants are consumed
    {
      const int r = t % GROUP;
      const float* rec = src + ((long long)g * GROUP + r) * REC;
      for (int q = 0; q < 2; ++q) {
        const int p = (t / GROUP) * 2 + q;
        const float ex = rec[3 * p], ey = rec[3 * p + 1], ew = rec[3 * p + 2];
        const float ex2 = __fmul_rn(ex, 0.5f);
        const float ey2 = __fmul_rn(ey, 0.5f);
        float ew2 = __fadd_rn(__fadd_rn(ew, __fmul_rn(ex, x0)),
                              __fmul_rn(ey, y0));
        if (p < 3) {
          const float e = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(fabsf(ex2), 2.0f * TILE_W),
                                  __fmul_rn(fabsf(ey2), 2.0f * TILE_H)),
                        fabsf(ew2)),
              EDGE_BIAS);
          ew2 = __fadd_rn(ew2, e);
        }
        float* c = consts[r] + 6 * p;
        c[0] = bf16_round(ex2);
        c[1] = bf16_round(ey2);
        c[2] = bf16_round(ew2);
        c[3] = bf16_round(__fsub_rn(ex2, c[0]));
        c[4] = bf16_round(__fsub_rn(ey2, c[1]));
        c[5] = bf16_round(__fsub_rn(ew2, c[2]));
      }
    }
    __syncthreads();
    for (int r = 0; r < GROUP; ++r) {
      const float* c = consts[r];
      float axh[4], axl[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        axh[p] = __fmul_rn(c[6 * p], X);
        axl[p] = __fmul_rn(c[6 * p + 3], X);
      }
      const int row = g * GROUP + r;
      const int id = global_tier ? -2 - row : row;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float Y = (float)(2 * (row0 + i) + 1);
        float b[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float hi = __fadd_rn(__fadd_rn(axh[p], __fmul_rn(c[6 * p + 1], Y)),
                                     c[6 * p + 2]);
          const float lo = __fadd_rn(__fadd_rn(axl[p], __fmul_rn(c[6 * p + 4], Y)),
                                     c[6 * p + 5]);
          b[p] = __fadd_rn(hi, lo);
        }
        const bool cover = b[0] >= 0.0f && b[1] >= 0.0f && b[2] >= 0.0f &&
                           b[3] >= 0.0f;
        if (cover && b[3] < depth[i]) {
          depth[i] = b[3];
          win[i] = id;
        }
      }
    }
  }
}

// The whole stream of tile (tx, ty): global tier, tile-row tier, tile
// tier, each segment rounded out to whole groups.
template <int REC>
__device__ __forceinline__ void stream_tile(
    const float* __restrict__ pairs, const float* __restrict__ gpairs,
    const int* __restrict__ starts, const int* __restrict__ rstarts,
    const int* __restrict__ gmeta, int tx, int ty, int tiles_x,
    float (*consts)[PLANE_CONSTS], int lx, int row0, float* depth,
    int* win) {
  const int tile = ty * tiles_x + tx;
  const float x0 = (float)(tx * TILE_W);
  const float y0 = (float)(ty * TILE_H);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    depth[i] = 1.0f;
    win[i] = -1;
  }
  const int gcount = gmeta[0];
  stream_groups<REC>(gpairs, 0, (gcount + GROUP - 1) / GROUP, true, x0, y0,
                     consts, lx, row0, depth, win);
  stream_groups<REC>(pairs, rstarts[ty] / GROUP,
                     (rstarts[ty + 1] + GROUP - 1) / GROUP, false, x0, y0,
                     consts, lx, row0, depth, win);
  stream_groups<REC>(pairs, starts[tile] / GROUP,
                     (starts[tile + 1] + GROUP - 1) / GROUP, false, x0, y0,
                     consts, lx, row0, depth, win);
}

}  // namespace vq_raster
