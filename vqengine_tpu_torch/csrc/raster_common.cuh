// The tile stream shared by the raster kernels: K1 (raster_gbuf.cu,
// 32-float records) and K2 (raster_vis.cu, 16-float records), each in a
// center-sample and an MSAA 4x mode.
//
// One CTA of 256 threads owns one 16x128-pixel tile; each thread owns 8
// pixels (one column, eight rows), so warp w owns a 32x8-pixel footprint
// (columns 32 (w % 4) .., rows 8 (w / 4) ..). The tile walks the records
// of the reference's stream (global tier, tile-row tier, tile tier, each
// segment rounded out to whole groups of 128 records) in that order and
// keeps, per pixel and carry, the record with the smallest depth key; a
// candidate wins only if its key is strictly below the carry, so the first
// minimum in stream order wins, exactly as the reference's per-group
// argmin followed by a strict compare. The sample modes (the plain
// version's _group_keys):
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
// contracts them on the CPU. The plane evaluation stays on the CUDA
// cores: the winner and its tie-break hang on these exact roundings, and
// a tensor-core MMA neither orders nor rounds its accumulation in a
// specified way.
//
// The stream (stream_tile_reject, every kernel): a record is evaluated
// only where its planes can reach. The stream is cut into batches of 256
// records, each loaded (its 12 plane floats, as 16-byte cp.async copies,
// three threads to a record) into a two-slot ring while the previous batch
// is evaluated. (a) Each thread folds one record's plane constants and
// tests it against the whole tile; the survivors are compacted in stream
// order (ballot and prefix) and only they get their bf16 split and
// thresholds or sample offsets. (b) Each warp tests 32 survivors at a time
// against its own footprint (one per lane, then a ballot) and evaluates,
// in stream order, only those that pass: a warp-uniform branch, so a
// skipped record costs the warp one test instead of 8 pixels x 4 planes
// per lane. Three __syncthreads per batch of 256 records. K2's center mode
// adds the occlusion reject to (b) (OCCLUDE, below).
//
// Why skipping is exact. A record that covers no pixel and no sample of a
// block changes nothing there: in CENTER mode cover is false; in COVERAGE
// mode its coverage bits are 0 and its key is the clear value 4, which is
// never below the carry; in SAMPLES4 mode no sample is covered. So dropping it leaves every carry, winner and bit
// as they were, and the survivors keep their stream order. The test
// (reject_record) rejects only such records, for the mode's own test and
// with the window ignored (it only removes fragments):
// - each plane is affine in the tile-local (X, Y), so over a block of
//   pixel centres X in [X0, X1], Y in [Y0, Y1] its real value
//   V = ex2 X + ey2 Y + ew2 (the f32 constants above, before the split) is
//   largest (smallest) at a corner, picked by the signs of ex2 and ey2;
// - reject where, for an edge, Vmax + M lies below the smallest value the
//   mode accepts: 0 for CENTER; for COVERAGE a lower bound of every
//   sample threshold, coverage bits' and key's alike, and of 0 (the
//   centre): -(3/8)(|ex| + |ey|)(1 + 2^-20) = -(3/4)(|ex2| + |ey2|)(1 +
//   2^-20) (|dx|, |dy| <= 3/8; each rounded threshold is within 2^-23 of
//   the sum of its absolute products);
// - reject where zmax + M < 0, and in COVERAGE mode also where
//   zmin - M > 1;
// - SAMPLES4: sample s is covered where every fl(b_i + o_is) >= 0, o_is =
//   sample_offset(e_ix, e_iy, dx_s, dy_s) for the three edges and the
//   depth plane alike. |o_is| <= (3/8)(|e_ix| + |e_iy|)(1 + 2^-22), the
//   products and the sum each rounding by at most 2^-24, so reject where
//   Vmax + M < -(3/4)(|ex2| + |ey2|)(1 + 2^-20) for any of the four
//   planes. The sample's one extra f32 addition needs no margin of its
//   own: the sum of two floats rounds to a float of the same sign (a
//   nonzero sum of two floats never rounds to zero, with subnormals), so
//   where b_i + o_is < 0 exactly, its f32 sum fails the test too, and M
//   already bounds b_i against V;
// - killed records (e'0 = (0, 0, -1)) fail edge 0 by about 1 everywhere.
// The margin M = 2^-15 A + 2^-100, A = |ex2| X1 + |ey2| Y1 + |ew2|,
// bounds what the kernel computes against V. With h = bf16(v) and
// l = bf16(v - h) (v - h exact in f32), |v - (h + l)| <= 2^-8 |v - h|
// <= 2^-16 |v| (bf16 keeps 8 significant bits; below 2^-126 the bf16
// rounding adds at most 2^-134 absolute), so the split plane S = (hx+lx) X
// + (hy+ly) Y + (hw+lw) is within 2^-16 A of V. The products against X
// and Y are exact; the five f32 additions ((p + q) + hw, likewise for lo,
// then hi + lo) each round by at most 2^-24 of a partial sum bounded by
// (1 + 2^-7) A, so the computed value is within 3.1 * 2^-24 A of S. In all
// |computed - V| <= (2^-16 + 2^-22) A + 2^-126 < M / 1.9. The test is
// evaluated in f64 (products against X and Y exact, then rounded sums),
// whose own error (2^-52 relative) the factor of 1.9 absorbs. A NaN plane
// fails every compare, so it is never rejected. ops/raster.py's
// reject_block is the same test in PyTorch, operation for operation.
//
// The occlusion reject (OCCLUDE: K2's center mode, which keeps only the
// nearest depth and its id: no G-buffer, coverage bits or window). In
// (b), each warp takes the largest of its footprint's 256 depth carries
// (per lane over its 8 rows, then shuffles: no barrier) once before each
// 32 survivors, and a lane also drops its survivor where the depth floor
// F = Vmin - M of the z plane over the footprint's pixel centres (f64, as
// above: depth_floor) is >= that largest carry D. Exact: the computed z at
// every pixel of the footprint is within M / 1.9 of V >= Vmin, so above F
// >= D; carries only fall, so D is at least each pixel's carry when the
// record's turn comes; and the strict z < depth then fails everywhere, so
// the record would change no depth and no id. The cleared carry 1.0 is a
// carry like any other (a record can win there only with z < 1), and a
// NaN plane gives a NaN floor, which is never >= D. Nothing changes for a
// record that covers nothing: (a) and the footprint test already drop it.
// ops/raster.py's depth_reject_block is the plain mirror. No tile-level
// depth test: it would cost another barrier per batch.
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
constexpr int PLANE_F = 12;                       // plane floats per record
constexpr int NS = 4;                             // MSAA samples
constexpr float EDGE_BIAS = 3.0517578125e-05f;    // 2^-15
constexpr int BATCH = THREADS;                    // records per pass (reject stream)
constexpr double REJECT_REL = 0x1p-15;            // margin per unit of A
constexpr double REJECT_ABS = 0x1p-100;           // margin floor
constexpr double REJECT_THR = 1.0 + 0x1p-20;      // MSAA threshold bound slack

enum Mode { CENTER = 0, COVERAGE = 1, SAMPLES4 = 2 };

// Per-mode constants: floats per record in shared memory and depth
// carries per pixel.
template <int MODE> struct ModeInfo;
template <> struct ModeInfo<CENTER> {
  static constexpr int NC = PLANE_CONSTS, CARRIES = 1;
};
template <> struct ModeInfo<COVERAGE> {
  // the coverage bits' thresholds per sample and edge, then the key's
  // thresholds of sample 1, the only sample where they round otherwise
  static constexpr int NC = PLANE_CONSTS + 3 * NS + 3, CARRIES = 1;
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
// raster.MSAA_KEY_FUSED for the depth key's test), [sample][edge]: the
// two differ in sample 1 alone.
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

// The tile-local constants of plane p of one record (rec: its 12 plane
// floats) for the tile at (x0, y0), before the split: t[0..2] = ex/2, ey/2,
// fma(ey, y0, fma(ex, x0, ew)) [+ the edge bias for p < 3].
__device__ __forceinline__ void fold_plane(const float* rec, int p, float x0,
                                           float y0, float* t) {
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
  t[0] = ex2;
  t[1] = ey2;
  t[2] = ew2;
}

// The bf16 hi/lo split of one plane's folded constants t (3) into c (6):
// hx, hy, hw, lx, ly, lw.
__device__ __forceinline__ void split_plane(const float* t, float* c) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float h = bf16_round(t[k]);
    c[k] = h;
    c[3 + k] = bf16_round(__fsub_rn(t[k], h));
  }
}

// Whether a record can change nothing on the pixel centres X in [X0, X1],
// Y in [Y0, Y1] (tile-local, X = 2 lx + 1): the header's test, in f64.
// t: the folded constants (fold_plane), element k at t[k * stride].
template <int MODE>
__device__ __forceinline__ bool reject_record(const float* t, int stride,
                                              double X0, double X1,
                                              double Y0, double Y1) {
  bool rej = false;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const double a = t[(3 * p) * stride], b = t[(3 * p + 1) * stride];
    const double c = t[(3 * p + 2) * stride];
    const double aa = fabs(a), ab = fabs(b);
    const double vmax = __dadd_rn(__dadd_rn(__dmul_rn(a, a >= 0.0 ? X1 : X0),
                                            __dmul_rn(b, b >= 0.0 ? Y1 : Y0)),
                                  c);
    const double m = __dadd_rn(
        __dmul_rn(__dadd_rn(__dadd_rn(__dmul_rn(aa, X1), __dmul_rn(ab, Y1)),
                            fabs(c)),
                  REJECT_REL),
        REJECT_ABS);
    const double top = __dadd_rn(vmax, m);
    // the smallest value the mode accepts: 0, or a lower bound of every
    // sample's threshold (the sample's offset, negated)
    const double thr =
        MODE == CENTER ? 0.0
                       : -__dmul_rn(__dmul_rn(__dadd_rn(aa, ab), 0.75),
                                    REJECT_THR);
    if (p < 3 || MODE == SAMPLES4) {
      rej = rej || top < thr;
    } else {
      rej = rej || top < 0.0;
      if constexpr (MODE == COVERAGE) {
        const double vmin = __dadd_rn(
            __dadd_rn(__dmul_rn(a, a >= 0.0 ? X0 : X1),
                      __dmul_rn(b, b >= 0.0 ? Y0 : Y1)),
            c);
        rej = rej || __dsub_rn(vmin, m) > 1.0;
      }
    }
  }
  return rej;
}

// The occlusion reject's floor: the depth plane's smallest real value over
// the pixel centres X in [X0, X1], Y in [Y0, Y1], less the margin M, in
// f64 (t as in reject_record). The computed z of every pixel there is
// above it.
__device__ __forceinline__ double depth_floor(const float* t, int stride,
                                              double X0, double X1,
                                              double Y0, double Y1) {
  const double a = t[9 * stride], b = t[10 * stride], c = t[11 * stride];
  const double vmin = __dadd_rn(__dadd_rn(__dmul_rn(a, a >= 0.0 ? X0 : X1),
                                          __dmul_rn(b, b >= 0.0 ? Y0 : Y1)),
                                c);
  const double m = __dadd_rn(
      __dmul_rn(__dadd_rn(__dadd_rn(__dmul_rn(fabs(a), X1),
                                    __dmul_rn(fabs(b), Y1)),
                          fabs(c)),
                REJECT_REL),
      REJECT_ABS);
  return __dsub_rn(vmin, m);
}

// One record (constants c, ModeInfo<MODE>::NC floats; winner id `id`)
// against the thread's ROWS pixels of column X, rows row0 ..: the sample
// modes of the header. depth/win hold CARRIES x ROWS entries
// (carry-major); cov (COVERAGE only) bit 4*i + s = sample s of row i
// covered; zlo/zhi (BOUNDED only) the window of each of the thread's
// pixels.
template <int MODE, bool BOUNDED>
__device__ __forceinline__ void eval_record(const float* c, int id, float X,
                                            int row0, float* depth, int* win,
                                            unsigned* cov, const float* zlo,
                                            const float* zhi) {
  static_assert(!BOUNDED || MODE != SAMPLES4, "K2 has no bounded variant");
  float axh[4], axl[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    axh[p] = __fmul_rn(c[6 * p], X);
    axl[p] = __fmul_rn(c[6 * p + 3], X);
  }
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
      const float* tk = th + 3 * NS;     // sample 1's key thresholds
      unsigned bits = 0;
      bool any = false;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        bool in = zok, kin = zok;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const bool ok = b[e] >= th[3 * s + e];
          in = in && ok;
          kin = kin && (s == 1 ? b[e] >= tk[e] : ok);
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

template <int MODE>
__device__ __forceinline__ void clear_carries(float* depth, int* win,
                                              unsigned* cov) {
#pragma unroll
  for (int i = 0; i < ModeInfo<MODE>::CARRIES * ROWS; ++i) {
    depth[i] = clear_value<MODE>();
    win[i] = -1;
  }
  *cov = 0;
}

// ---------------------------------------------------------------------------
// stream_tile_reject: records evaluated only where their planes can reach
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared memory of stream_tile_reject, in floats: the two-slot ring of
// raw plane rows, the survivors' folded constants (structure of arrays,
// for the per-lane footprint test), their split constants and thresholds
// (array of structures, read as broadcasts), their ids, the warps'
// survivor counts.
template <int MODE> struct RejectSmem {
  static constexpr int RING = 2 * BATCH * PLANE_F;
  static constexpr int TEST = RING;
  static constexpr int CONSTS = TEST + PLANE_F * BATCH;
  static constexpr int IDS = CONSTS + ModeInfo<MODE>::NC * BATCH;
  static constexpr int WSUM = IDS + BATCH;
  static constexpr int FLOATS = WSUM + THREADS / 32;
  static constexpr int BYTES = FLOATS * 4;
};

// The stream's records as one sequence: v < ng the global tier, then the
// tile-row tier's groups from row r0, then the tile tier's from f0.
struct StreamMap {
  int ng, nr, r0, f0;
  __device__ __forceinline__ long long row(int v) const {
    return v < ng ? v : v < ng + nr ? r0 + (v - ng) : f0 + (v - ng - nr);
  }
  // winners from the global tier are encoded as -2 - row, from the pair
  // array as row (>= 0); -1 = none
  __device__ __forceinline__ int id(int v) const {
    return v < ng ? -2 - v : (int)row(v);
  }
};

// Copy batch b's plane rows (records [b * BATCH, ...) of the stream,
// 12 floats each) into ring slot `slot`: three 16-byte copies a record,
// consecutive threads on consecutive pieces.
template <int REC>
__device__ __forceinline__ void load_batch(const float* __restrict__ pairs,
                                           const float* __restrict__ gpairs,
                                           const StreamMap& m, int n, int b,
                                           float* slot) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int piece = k * THREADS + threadIdx.x;
    const int r = piece / 3, part = piece % 3;
    const int v = b * BATCH + r;
    if (v < n) {
      const float* src = (v < m.ng ? gpairs : pairs) + m.row(v) * REC + 4 * part;
      cp_async16(slot + r * PLANE_F + 4 * part, src);
    }
  }
}

// OCCLUDE (K2 center only): (b) also drops the survivors that the
// footprint's current depths hide (the header's occlusion reject).
template <int REC, int MODE, bool BOUNDED, bool OCCLUDE>
__device__ __forceinline__ void stream_tile_reject(
    const float* __restrict__ pairs, const float* __restrict__ gpairs,
    const int* __restrict__ starts, const int* __restrict__ rstarts,
    const int* __restrict__ gmeta, int tx, int ty, int tiles_x, float* smem,
    int lx, int row0, float* depth, int* win, unsigned* cov,
    const float* zlo, const float* zhi) {
  static_assert(!OCCLUDE || (MODE == CENTER && !BOUNDED),
                "the occlusion reject is exact for K2's center mode only");
  using S = RejectSmem<MODE>;
  constexpr int NC = ModeInfo<MODE>::NC;
  float* ring = smem;
  float* test = smem + S::TEST;
  float* consts = smem + S::CONSTS;
  int* ids = reinterpret_cast<int*>(smem + S::IDS);
  int* wsum = reinterpret_cast<int*>(smem + S::WSUM);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int tile = ty * tiles_x + tx;
  const float x0 = (float)(tx * TILE_W);
  const float y0 = (float)(ty * TILE_H);
  clear_carries<MODE>(depth, win, cov);

  StreamMap m;
  m.ng = (gmeta[0] + GROUP - 1) / GROUP * GROUP;
  m.r0 = rstarts[ty] / GROUP * GROUP;
  m.nr = (rstarts[ty + 1] + GROUP - 1) / GROUP * GROUP - m.r0;
  m.f0 = starts[tile] / GROUP * GROUP;
  const int nf = (starts[tile + 1] + GROUP - 1) / GROUP * GROUP - m.f0;
  const int n = m.ng + m.nr + nf;
  const int nb = (n + BATCH - 1) / BATCH;

  const float X = (float)(2 * lx + 1);
  // this warp's footprint: columns lx - lane .. + 31, rows row0 .. + 7
  const double fx0 = 2.0 * (lx - lane) + 1.0, fy0 = 2.0 * row0 + 1.0;
  const double fx1 = fx0 + 62.0, fy1 = fy0 + 2.0 * (ROWS - 1);

  load_batch<REC>(pairs, gpairs, m, n, 0, ring);
  cp_async_commit();
  for (int b = 0; b < nb; ++b) {
    // the slot refilled here was last read in (a) of batch b - 1, before
    // its second barrier
    if (b + 1 < nb)
      load_batch<REC>(pairs, gpairs, m, n, b + 1,
                      ring + ((b + 1) & 1) * BATCH * PLANE_F);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();  // batch b landed; batch b - 1's survivors consumed

    // (a) one record per thread against the whole tile
    const int v = b * BATCH + t;
    float raw[PLANE_F], folded[PLANE_F];
    bool keep = false;
    if (v < n) {
      const float4* q = reinterpret_cast<const float4*>(
          ring + (b & 1) * BATCH * PLANE_F + t * PLANE_F);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 f = q[k];
        raw[4 * k] = f.x;
        raw[4 * k + 1] = f.y;
        raw[4 * k + 2] = f.z;
        raw[4 * k + 3] = f.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) fold_plane(raw, p, x0, y0, folded + 3 * p);
      keep = !reject_record<MODE>(folded, 1, 1.0, 2.0 * TILE_W - 1.0, 1.0,
                                  2.0 * TILE_H - 1.0);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wsum[warp] = __popc(ball);
    __syncthreads();
    int pos = __popc(ball & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = wsum[w];
      pos += w < warp ? c : 0;
      total += c;
    }
    if (keep) {
#pragma unroll
      for (int k = 0; k < PLANE_F; ++k) test[k * BATCH + pos] = folded[k];
      float* c = consts + pos * NC;
#pragma unroll
      for (int p = 0; p < 4; ++p) split_plane(folded + 3 * p, c + 6 * p);
      if constexpr (MODE == COVERAGE) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float ex = raw[3 * e], ey = raw[3 * e + 1];
#pragma unroll
          for (int s = 0; s < NS; ++s)
            c[PLANE_CONSTS + 3 * s + e] =
                msaa_threshold(ex, ey, s, coverage_fused(s, e));
          c[PLANE_CONSTS + 3 * NS + e] = msaa_threshold(ex, ey, 1, key_fused(1, e));
        }
      } else if constexpr (MODE == SAMPLES4) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            c[PLANE_CONSTS + 4 * s + p] = sample_offset(
                raw[3 * p], raw[3 * p + 1], sample_dx(s), sample_dy(s));
        }
      }
      ids[pos] = m.id(v);
    }
    __syncthreads();  // the survivors are in place

    // (b) per warp: 32 survivors tested against the footprint (and with
    // OCCLUDE against its largest current depth), then the kept ones
    // evaluated in stream order
    for (int c0 = 0; c0 < total; c0 += 32) {
      const int i = c0 + lane;
      bool mine = i < total && !reject_record<MODE>(test + i, BATCH, fx0,
                                                    fx1, fy0, fy1);
      if constexpr (OCCLUDE) {
        float farthest = depth[0];
#pragma unroll
        for (int r = 1; r < ROWS; ++r) farthest = fmaxf(farthest, depth[r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          farthest = fmaxf(farthest, __shfl_xor_sync(0xffffffffu, farthest, o));
        mine = mine && !(depth_floor(test + i, BATCH, fx0, fx1, fy0, fy1) >=
                         (double)farthest);
      }
      unsigned kept = __ballot_sync(0xffffffffu, mine);
      while (kept) {
        const int r = c0 + __ffs(kept) - 1;
        kept &= kept - 1u;
        eval_record<MODE, BOUNDED>(consts + r * NC, ids[r], X, row0, depth,
                                   win, cov, zlo, zhi);
      }
    }
  }
}

}  // namespace vq_raster
