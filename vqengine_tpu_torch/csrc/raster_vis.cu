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
// the hi part, the same for the lo part, one add) per evaluated record per
// pixel (36), plus 16 offset adds per pixel in the MSAA variant (52),
// against the card's fp32 rate outside the tensor cores. What the inputs
// need: in the center variant, each winner evaluated at least on the 8x4
// block it wins in (the distinct (tri_id, block) pairs of the output: the
// occlusion reject below makes a covered but hidden pair no work the
// inputs need); in the MSAA variant, the (record, 8x4 block) pairs in
// which the record covers a sample (raster.covered_block_pairs). Memory
// traffic is small: 12 plane floats per streamed record, one id per pixel
// and sample, 8 bytes of output per pixel and sample.
//
// Design: the reject stream of raster_common.cuh (stream_tile_reject), as
// K1's: a record is evaluated only by the warps whose 32x8 footprint its
// planes can reach, after a tile-level test that compacts the survivors.
// The center variant adds the occlusion reject: a warp also skips a
// survivor whose depth plane stays, with the margin, at or above its
// footprint's largest current depth, which is exact because K2 keeps only
// the nearest depth and its id. Shadow views are covered everywhere with
// deep overdraw, so that is where most of its pairs go. The skipped pairs
// provably change nothing, so the outputs stay bitwise those of the plain
// version, which evaluates every record everywhere. The ring, the
// survivors' constants and ids take 61 KB (center) or 77 KB (MSAA) of
// dynamic shared memory per CTA; no resolve. No tensor cores (the header
// says why). On Sponza's 8 caster views the evaluation of the kept
// (record, footprint) pairs is most of the time (a build that skips it
// ran in a fifth of it), and the occlusion reject drops about 15% of
// those pairs: records arrive in the reference's stream order, not front
// to back.
#include "raster_common.cuh"

namespace {

using namespace vq_raster;

constexpr int REC = 16;          // floats per record
constexpr int ID_ROW = 12;

// Three CTAs per SM for the center variant (at most 85 registers; 80
// used, no spills; its 62,496 bytes of shared memory fit three times), two
// for the MSAA variant (128 registers), as K1's: on an H100 the center
// variant ran 1.5-2% faster with three than with two (112 registers),
// the MSAA one 7% slower with three (80 registers and spills)
// (tools/time_kernels_torch.py, both builds timed on one card).
template <int MODE>
__global__ void __launch_bounds__(THREADS, MODE == CENTER ? 3 : 2)
raster_vis_kernel(const float* __restrict__ pairs,
                  const float* __restrict__ gpairs,
                  const int* __restrict__ starts,
                  const int* __restrict__ rstarts,
                  const int* __restrict__ gmeta,
                  int tiles_x, int width, int height,
                  float* __restrict__ depth_out, int* __restrict__ id_out) {
  constexpr int K = ModeInfo<MODE>::CARRIES;
  extern __shared__ float4 smem[];
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int lx = threadIdx.x % TILE_W;
  const int row0 = (threadIdx.x / TILE_W) * ROWS;
  float depth[K * ROWS];
  int win[K * ROWS];
  unsigned cov = 0;
  stream_tile_reject<REC, MODE, false, MODE == CENTER>(
      pairs, gpairs, starts, rstarts, gmeta, tx, ty, tiles_x,
      reinterpret_cast<float*>(smem), lx, row0, depth, win, &cov, nullptr,
      nullptr);

  const int x = tx * TILE_W + lx;
  if (x >= width) return;
  const long long plane = (long long)width * height;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int y = ty * TILE_H + row0 + i;
      if (y < height) {
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
}

template <int MODE>
int launch(const void* pairs, const void* gpairs, const void* starts,
           const void* rstarts, const void* gmeta, int tiles_x, int tiles_y,
           int width, int height, void* depth, void* tri_id, void* stream) {
  if (tiles_x > 0 && tiles_y > 0) {
    constexpr int bytes = RejectSmem<MODE>::BYTES;
    const cudaError_t e = cudaFuncSetAttribute(
        raster_vis_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    raster_vis_kernel<MODE><<<dim3(tiles_x, tiles_y), THREADS, bytes,
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

// Dynamic shared memory per CTA of the center (msaa 0) or MSAA 4x (msaa 1)
// variant: ptxas reports static memory only.
extern "C" int vq_raster_vis_smem_bytes(int msaa) {
  return msaa ? RejectSmem<SAMPLES4>::BYTES : RejectSmem<CENTER>::BYTES;
}
