// The tile stream shared by the raster kernels: K1 (raster_gbuf.cu,
// 32-float records) and K2 (raster_vis.cu, 16-float records), each in a
// center-sample and an MSAA 4x mode.
//
// One CTA of 256 threads owns one 16x128-pixel tile; each thread owns 8
// pixels (one column, eight rows). The tile streams groups of 128 records
// in the reference's order (global tier, tile-row tier, tile tier, each
// segment rounded out to whole groups by the caller) and keeps, per pixel
// and carry, the record with the smallest depth key; a candidate wins only
// if its key is strictly below the carry, so the first minimum in stream
// order wins, exactly as the reference's per-group argmin followed by a
// strict compare. The sample modes (the plain version's _group_keys):
// - CENTER (K1, K2): covered where b0, b1, b2, z >= 0; key z; carry 1.0.
// - COVERAGE (K1-MSAA): sample s covered where b_i(center) >= t_{i,s}
//   (t_{i,s} = -(e_ix dx_s + e_iy dy_s) from the unsplit record rows) and
//   0 <= z <= 1; key z where the center is covered, z + 1 where only a
//   sample is; carry 4.0; plus 4 sticky coverage bits per pixel. The
//   thresholds of the coverage bits and those of the key's "some sample
//   covered" round differently (msaa_threshold).
// - SAMPLES4 (K2-msaa4): per sample, b_i + (e_ix dx_s + e_iy dy_s) added
//   to the split values; four carries.
// BOUNDED (K1-bounded, CENTER and COVERAGE): a fragment competes only
// where zlo < z < zhi (strict, the pixel-center z), a per-pixel window the
// caller loads into registers once per tile; in COVERAGE mode the window
// gates the coverage bits and the key's "some sample covered" too.
//
// Plane arithmetic. The reference's split evaluation (_plane_eval_dots in
// vqengine_tpu/ops/raster.py) is mirrored operation for operation: per
// record and tile, the plane constants (ex/2, ey/2, fma(ey, y0, fma(ex,
// x0, ew)) [+ 2^-15 edge bias]) are split into bf16 hi and lo parts
// (round to nearest even), and a pixel's value is ((hx*X + hy*Y) + hw) +
// ((lx*X + ly*Y) + lw) with X = 2*lx+1 and Y = 2*ly+1 tile-local. Each
// product is exact in f32; every operation is an explicit _rn intrinsic
// and the library is built with -fmad=false, so the result is bitwise
// equal to the plain PyTorch version. The two fused multiply-adds of the
// tile-origin fold, the one of sample 1's offset (sample_offset) and the
// fused K1-MSAA thresholds (msaa_threshold) are rounded as the plain
// version rounds them (in f64), because the reference's compiler
// contracts them on the CPU.
//
// The per-record constants of a group (24 plane constants, plus 24
// thresholds or 16 sample offsets in the MSAA modes) are computed once per
// tile by all 256 threads (each one record and two planes) into shared
// memory (12, 24 or 20 KB); then every thread walks the 128 records for
// its 8 pixels, with the column-dependent products hoisted out of the row
// loop.
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
constexpr int NS = 4;                             // MSAA samples
constexpr float EDGE_BIAS = 3.0517578125e-05f;    // 2^-15

enum Mode { CENTER = 0, COVERAGE = 1, SAMPLES4 = 2 };

// Per-mode constants: floats per record in shared memory and depth
// carries per pixel.
template <int MODE> struct ModeInfo;
template <> struct ModeInfo<CENTER> {
  static constexpr int NC = PLANE_CONSTS, CARRIES = 1;
};
template <> struct ModeInfo<COVERAGE> {
  // thresholds per sample and edge: the coverage bits', then the key's
  static constexpr int NC = PLANE_CONSTS + 2 * 3 * NS, CARRIES = 1;
};
template <> struct ModeInfo<SAMPLES4> {
  static constexpr int NC = PLANE_CONSTS + 4 * NS, CARRIES = NS;
};

// The depth carry's clear value: the depth key of K1-MSAA starts above
// both z and z + 1.
template <int MODE>
__device__ __forceinline__ float clear_value() {
  return MODE == COVERAGE ? 4.0f : 1.0f;
}

// D3D standard 4x sample offsets from the pixel center (MSAA4_OFFSETS).
__device__ __forceinline__ float sample_dx(int s) {
  return s == 0 ? -0.125f : s == 1 ? 0.375f : s == 2 ? -0.375f : 0.125f;
}
__device__ __forceinline__ float sample_dy(int s) {
  return s == 0 ? -0.375f : s == 1 ? -0.125f : s == 2 ? 0.125f : 0.375f;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a*b + c rounded as the plain version's _fma rounds it: the product is
// exact in f64, then one f64 add and one rounding to f32.
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// K2-msaa4's a*dx + b*dy as the reference rounds it (raster.sample_offset): the
// first product fused when its constant is positive, else two products.
__device__ __forceinline__ float sample_offset(float a, float b, float dx,
                                               float dy) {
  return dx > 0.0f ? fma_f64(a, dx, __fmul_rn(b, dy))
                   : __fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy));
}

// K1-MSAA's threshold -(a*dx + b*dy) of edge i at sample s, as the
// plain version's msaa_threshold rounds it: once (in f64) where fused,
// else as two rounded products added. Where it is fused follows the
// reference (raster.MSAA_COVERAGE_FUSED for the coverage bits,
// raster.MSAA_KEY_FUSED for the depth key's test), [sample][edge].
__device__ __forceinline__ bool coverage_fused(int s, int i) {
  return s == 1 || (i == 0 && (s == 0 || s == 3));
}
__device__ __forceinline__ bool key_fused(int s, int i) {
  return i == 0 && (s == 0 || s == 3);
}
__device__ __forceinline__ float msaa_threshold(float a, float b, int s,
                                                bool fused) {
  const float dx = sample_dx(s), dy = sample_dy(s);
  return fused ? -__double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)dx),
                                              __dmul_rn((double)b, (double)dy)))
               : -__fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy));
}

// Stream groups [g0, g1) of `src` (records of REC floats). Winners from
// the global tier are encoded as -2 - row, from the pair array as row
// (>= 0); -1 = none. depth/win hold CARRIES x ROWS entries (carry-major);
// cov (COVERAGE only) bit 4*i + s = sample s of row i covered; zlo/zhi
// (BOUNDED only) the window of each of the thread's ROWS pixels.
template <int REC, int MODE, bool BOUNDED>
__device__ __forceinline__ void stream_groups(
    const float* __restrict__ src, int g0, int g1, bool global_tier,
    float x0, float y0, float (*consts)[ModeInfo<MODE>::NC], int lx,
    int row0, float* depth, int* win, unsigned* cov, const float* zlo,
    const float* zhi) {
  static_assert(!BOUNDED || MODE != SAMPLES4, "K2 has no bounded variant");
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
        float ew2 = fma_f64(ey, y0, fma_f64(ex, x0, ew));
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
        if constexpr (MODE == COVERAGE) {
          if (p < 3) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              consts[r][PLANE_CONSTS + 3 * s + p] =
                  msaa_threshold(ex, ey, s, coverage_fused(s, p));
              consts[r][PLANE_CONSTS + 3 * NS + 3 * s + p] =
                  msaa_threshold(ex, ey, s, key_fused(s, p));
            }
          }
        }
        if constexpr (MODE == SAMPLES4) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            consts[r][PLANE_CONSTS + 4 * s + p] =
                sample_offset(ex, ey, sample_dx(s), sample_dy(s));
        }
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
        if constexpr (MODE == CENTER) {
          bool cover = b[0] >= 0.0f && b[1] >= 0.0f && b[2] >= 0.0f &&
                       b[3] >= 0.0f;
          if constexpr (BOUNDED) cover = cover && b[3] > zlo[i] && b[3] < zhi[i];
          if (cover && b[3] < depth[i]) {
            depth[i] = b[3];
            win[i] = id;
          }
        } else if constexpr (MODE == COVERAGE) {
          bool zok = b[3] >= 0.0f && b[3] <= 1.0f;
          if constexpr (BOUNDED) zok = zok && b[3] > zlo[i] && b[3] < zhi[i];
          const float* th = c + PLANE_CONSTS;
          const float* tk = th + 3 * NS;
          unsigned bits = 0;
          bool any = false;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            bool in = zok, kin = zok;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              const bool ok = b[e] >= th[3 * s + e];
              in = in && ok;
              // the key's threshold is read only where it rounds otherwise
              kin = kin && (coverage_fused(s, e) == key_fused(s, e)
                                ? ok : b[e] >= tk[3 * s + e]);
            }
            bits |= (unsigned)in << s;
            any = any || kin;
          }
          *cov |= bits << (NS * i);
          const bool center = zok && b[0] >= 0.0f && b[1] >= 0.0f &&
                              b[2] >= 0.0f;
          const float key = center ? b[3]
                            : any ? __fadd_rn(b[3], 1.0f)
                                  : clear_value<COVERAGE>();
          if (key < depth[i]) {
            depth[i] = key;
            win[i] = id;
          }
        } else {
          const float* off = c + PLANE_CONSTS;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float z = __fadd_rn(b[3], off[4 * s + 3]);
            const bool cover = __fadd_rn(b[0], off[4 * s]) >= 0.0f &&
                               __fadd_rn(b[1], off[4 * s + 1]) >= 0.0f &&
                               __fadd_rn(b[2], off[4 * s + 2]) >= 0.0f &&
                               z >= 0.0f;
            if (cover && z < depth[s * ROWS + i]) {
              depth[s * ROWS + i] = z;
              win[s * ROWS + i] = id;
            }
          }
        }
      }
    }
  }
}

// The whole stream of tile (tx, ty): global tier, tile-row tier, tile
// tier, each segment rounded out to whole groups.
template <int REC, int MODE, bool BOUNDED = false>
__device__ __forceinline__ void stream_tile(
    const float* __restrict__ pairs, const float* __restrict__ gpairs,
    const int* __restrict__ starts, const int* __restrict__ rstarts,
    const int* __restrict__ gmeta, int tx, int ty, int tiles_x,
    float (*consts)[ModeInfo<MODE>::NC], int lx, int row0, float* depth,
    int* win, unsigned* cov, const float* zlo = nullptr,
    const float* zhi = nullptr) {
  const int tile = ty * tiles_x + tx;
  const float x0 = (float)(tx * TILE_W);
  const float y0 = (float)(ty * TILE_H);
#pragma unroll
  for (int i = 0; i < ModeInfo<MODE>::CARRIES * ROWS; ++i) {
    depth[i] = clear_value<MODE>();
    win[i] = -1;
  }
  *cov = 0;
  const int gcount = gmeta[0];
  stream_groups<REC, MODE, BOUNDED>(gpairs, 0, (gcount + GROUP - 1) / GROUP,
                                    true, x0, y0, consts, lx, row0, depth,
                                    win, cov, zlo, zhi);
  stream_groups<REC, MODE, BOUNDED>(pairs, rstarts[ty] / GROUP,
                                    (rstarts[ty + 1] + GROUP - 1) / GROUP,
                                    false, x0, y0, consts, lx, row0, depth,
                                    win, cov, zlo, zhi);
  stream_groups<REC, MODE, BOUNDED>(pairs, starts[tile] / GROUP,
                                    (starts[tile + 1] + GROUP - 1) / GROUP,
                                    false, x0, y0, consts, lx, row0, depth,
                                    win, cov, zlo, zhi);
}

}  // namespace vq_raster
