// K3 palette lookup: out[p, c] = T[clamp(idx[p], 0, mp-1), c].
//
// Replaces the Pallas kernel of vqengine_tpu/ops/palette.py
// (_make_kernel / palette_lookup). The TPU computes the lookup as a
// one-hot [mp, 4096] x [mp, K] MXU product because per-pixel gathers are
// slow there; on Hopper it is a row gather.
//
// Semantics kept from the TPU version: the table is zero-padded to
// mp = max(8, ceil(M/8)*8) rows, and the index is clamped to [0, mp-1]
// before the fetch. So negative ids read row 0, ids in [M, mp) read zeros
// and ids >= mp read row mp-1 (which is a zero row whenever mp > M).
//
// Bound: memory, and almost all of it the output. The frame's largest
// lookup, the material fetch [M, 32] x 1080p, writes 265 MB and reads 8 MB
// of ids; the table is a few KB.
//
// Design: a vectorised row gather. The flattened output [n * K] is cut
// into 16-byte segments, and each thread of a grid-stride loop writes
// whole segments with one streaming float4 store (__stcs: the output is
// written once and not read back here, and the 50 MB L2 cannot hold it),
// consecutive threads on consecutive segments. Where K % 4 == 0 (32, 16)
// a segment is four columns of one row; otherwise (K = 2, 9, 17) it is
// four consecutive floats of the flattened output, each finding its row,
// and the last n * K % 4 floats are stored one by one. The row of a
// segment or float is a 32-bit divide by a constant, done as a multiply by
// a magic number (the wrapper keeps n * K < 2^31). Each CTA first stages
// the zero-padded table in shared memory (a few KB); a table larger than
// SMEM_MAX is read through __ldg instead, in the same kernel. An exact
// copy, so bitwise equal to the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 48 * 1024;   // the default dynamic shared memory
constexpr int SEGS_PER_THREAD = 8;    // at least, before the grid is capped
constexpr int MAX_BLOCKS = 132 * 8;   // 8 CTAs on each of an H100's SMs

// n / d for 0 <= n < 2^31 and a divisor d >= 1 with magic and shift from
// magic_for (Granlund and Montgomery's round-up method: with l =
// ceil(log2 d) and magic = floor(2^32 (2^l - d) / d) + 1 the quotient is
// exact for every 32-bit n).
__device__ __forceinline__ int fast_div(int n, unsigned magic, int shift) {
  return (int)((__umulhi((unsigned)n, magic) + (unsigned)n) >> shift);
}

void magic_for(unsigned d, unsigned* magic, int* shift) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  *magic = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  *shift = l;
}

__device__ __forceinline__ int clamp_row(int j, int mp) {
  return j < 0 ? 0 : (j > mp - 1 ? mp - 1 : j);
}

// VEC: K % 4 == 0, the divisor is K / 4 (segments per row); else the
// divisor is K. SMEM: the padded table is staged in shared memory.
template <bool VEC, bool SMEM>
__global__ void __launch_bounds__(THREADS)
palette_kernel(const int* __restrict__ idx, const float* __restrict__ table,
               float* __restrict__ out, int n, int m, int mp, int k,
               unsigned magic, int shift) {
  extern __shared__ float4 staged4[];
  float* staged = reinterpret_cast<float*>(staged4);
  if constexpr (SMEM) {
    const int used = m * k, all = mp * k;
    for (int i = threadIdx.x; i < all; i += THREADS)
      staged[i] = i < used ? __ldg(table + i) : 0.0f;
    __syncthreads();
  }
  // element c of row j of the padded table
  auto value = [&](int j, int c) -> float {
    if constexpr (SMEM) return staged[j * k + c];
    return j < m ? __ldg(table + j * k + c) : 0.0f;
  };
  const int total = n * k;
  const int nseg = total >> 2;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int s = blockIdx.x * THREADS + threadIdx.x; s < nseg;
       s += gridDim.x * THREADS) {
    float4 v;
    if constexpr (VEC) {
      const int p = fast_div(s, magic, shift);
      const int c = 4 * (s - p * (k >> 2));
      const int j = clamp_row(__ldg(idx + p), mp);
      if constexpr (SMEM) {
        v = staged4[(j * k + c) >> 2];
      } else {
        v = make_float4(value(j, c), value(j, c + 1), value(j, c + 2),
                        value(j, c + 3));
      }
    } else {
      int p = fast_div(4 * s, magic, shift);
      int c = 4 * s - p * k;
      int j = clamp_row(__ldg(idx + p), mp);
      float f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[q] = value(j, c);
        if (++c == k && q < 3) {   // the next float starts row p + 1 < n
          c = 0;
          j = clamp_row(__ldg(idx + ++p), mp);
        }
      }
      v = make_float4(f[0], f[1], f[2], f[3]);
    }
    __stcs(out4 + s, v);
  }
  if constexpr (!VEC) {
    // the last total % 4 floats
    const int e = 4 * nseg + threadIdx.x;
    if (blockIdx.x == 0 && e < total) {
      const int p = fast_div(e, magic, shift);
      out[e] = value(clamp_row(__ldg(idx + p), mp), e - p * k);
    }
  }
}

template <bool VEC, bool SMEM>
void launch(const int* idx, const float* table, float* out, int n, int m,
            int mp, int k, cudaStream_t stream) {
  unsigned magic;
  int shift;
  magic_for(VEC ? k / 4 : k, &magic, &shift);
  const long long nseg = (long long)n * k / 4;
  long long blocks = (nseg + THREADS * SEGS_PER_THREAD - 1) /
                     (THREADS * SEGS_PER_THREAD);
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  const size_t smem = SMEM ? (size_t)mp * k * sizeof(float) : 0;
  palette_kernel<VEC, SMEM><<<(unsigned)blocks, THREADS, smem, stream>>>(
      idx, table, out, n, m, mp, k, magic, shift);
}

}  // namespace

// n * k < 2^31 and out 16-byte aligned (the wrapper checks and allocates).
extern "C" int vq_palette_lookup(const void* idx, const void* table,
                                 void* out, int n, int m, int mp, int k,
                                 void* stream) {
  if (n > 0 && k > 0) {
    const int* i = (const int*)idx;
    const float* t = (const float*)table;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    const bool vec = k % 4 == 0;
    const bool smem = (long long)mp * k * sizeof(float) <= SMEM_MAX;
    if (vec && smem) launch<true, true>(i, t, o, n, m, mp, k, s);
    else if (vec) launch<true, false>(i, t, o, n, m, mp, k, s);
    else if (smem) launch<false, true>(i, t, o, n, m, mp, k, s);
    else launch<false, false>(i, t, o, n, m, mp, k, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
