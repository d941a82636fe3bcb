// Column-pass NTT kernel for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA foreign function interface (target "ntt_colpass").
//
// One pass of the four-step transform: every column of a (batch, nn, cols)
// uint32 matrix gets an nn-point transform over a word prime p < 2^31,
// following twiddles.col_network's nested R x S schedule (nn = R * S,
// R = 2^floor(log2(nn)/2)), so the spectral output order is the XLA
// engine's bit for bit. Device memory is read once and written once per
// pass; the XLA engine pays one round trip per butterfly stage.
//
// Layout: one thread block per (batch row, tile of C = 16 adjacent
// columns). The nn x 16 tile lives in shared memory; each thread runs a
// whole R- or S-point sub-transform of one column from registers (radix-2
// stages fully unrolled), so a pass costs two shared-memory round trips
// and three barriers instead of log2(nn) of each.
//
// Logical tile row L = r * S + s (r < R, s < S).
//   forward (DIF, natural in, spectral out):
//     load   input row i          -> L = i
//     phase A: for each s, R-point DIF over r, then x *= wmid[r*S + s]
//     phase B: for each r, S-point DIF over s
//     store  output row j = s*R + r <- L = r*S + s
//   inverse (DIT, spectral in, natural out, unscaled):
//     load   input row j = s*R + r -> L = r*S + s
//     phase A: for each r, S-point DIT over s, then x *= wmid[r*S + s]
//     phase B: for each s, R-point DIT over r
//     store  output row i         <- L = i
// Optional epilogue/prologue: an elementwise constant multiply on load
// ("pre", in the input's (nn, cols) orientation) and on store ("post", in
// the output's orientation), and a transposed store that writes the tile's
// 16 columns as 16 contiguous rows of a (batch, cols, nn) output (the
// four-step transpose). Every value leaves the kernel canonical, in [0, p).
//
// Arithmetic: Shoup multiplication by a constant w with w' = floor(w 2^32/p)
// precomputed on the host: q = umulhi(x, w'), x*w - q*p lies in [0, 2p) for
// any x < 2^32, one conditional subtract makes it canonical. Butterflies
// keep canonical values, so p < 2^31 keeps every sum below 2^32.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kCols = 16;     // tile columns
constexpr int kThreads = 256;

struct Tw {
  uint32_t w, ws;  // twiddle and its Shoup constant
};

__device__ __forceinline__ uint32_t fold(uint32_t x, uint32_t p) {
  // [0, 2p) -> [0, p): x - p wraps above x when x < p
  return min(x, x - p);
}

__device__ __forceinline__ uint32_t mulc(uint32_t x, Tw t, uint32_t p) {
  uint32_t q = __umulhi(x, t.ws);
  return fold(x * t.w - q * p, p);
}

__device__ __forceinline__ Tw ldtw(const Tw* __restrict__ t, int i) {
  uint2 v = __ldg(reinterpret_cast<const uint2*>(t) + i);
  return Tw{v.x, v.y};
}

// Gentleman-Sande DIF, natural in, bit-reversed out. tw: stage s
// (half-block t = N >> (s+1)) at offset N - 2t, w^(j * 2^s) for j < t.
template <int LOG>
__device__ __forceinline__ void dif(uint32_t (&v)[1 << LOG],
                                    const Tw* tw, uint32_t p) {
  constexpr int N = 1 << LOG;
#pragma unroll
  for (int s = 0; s < LOG; ++s) {
    const int t = N >> (s + 1);
    const Tw* ts = tw + (N - 2 * t);
#pragma unroll
    for (int blk = 0; blk < N; blk += 2 * t) {
#pragma unroll
      for (int j = 0; j < t; ++j) {
        uint32_t a = v[blk + j], b = v[blk + j + t];
        v[blk + j] = fold(a + b, p);
        v[blk + j + t] = mulc(a - b + p, ts[j], p);
      }
    }
  }
}

// Cooley-Tukey DIT, bit-reversed in, natural out. tw: stage s
// (half-block t = 2^s) at offset t - 1, w^(j * N / (2t)) for j < t.
template <int LOG>
__device__ __forceinline__ void dit(uint32_t (&v)[1 << LOG],
                                    const Tw* tw, uint32_t p) {
  constexpr int N = 1 << LOG;
#pragma unroll
  for (int s = 0; s < LOG; ++s) {
    const int t = 1 << s;
    const Tw* ts = tw + (t - 1);
#pragma unroll
    for (int blk = 0; blk < N; blk += 2 * t) {
#pragma unroll
      for (int j = 0; j < t; ++j) {
        uint32_t a = v[blk + j];
        uint32_t b = mulc(v[blk + j + t], ts[j], p);
        v[blk + j] = fold(a + b, p);
        v[blk + j + t] = fold(a - b + p, p);
      }
    }
  }
}

// Shared-memory address of tile element (L, col). Rows with odd r swap
// their low bit and columns are XOR-swizzled by (r ^ s) & 14, which keeps
// every access pattern below free of bank conflicts: two rows L, L+1 or
// L, L+S across the 16 columns (phases, row-major loads and stores), and
// 16 aligned consecutive r or s across a column pair (transposed stores).
template <int LOGS>
__device__ __forceinline__ int phys(int L, int col) {
  const int r = L >> LOGS, s = L & ((1 << LOGS) - 1);
  return ((L ^ (r & 1)) << 4) + (col ^ ((r ^ s) & 14));
}

// Output (row j, tile column c) of store iteration `it`.
template <bool TOUT>
__device__ __forceinline__ void store_coords(int it, int& j, int& c) {
  if (TOUT) {
    const int rest = it >> 5;
    c = ((rest & 7) << 1) | ((it >> 4) & 1);
    j = ((rest >> 3) << 4) | (it & 15);
  } else {
    j = it >> 4;
    c = it & 15;
  }
}

template <int LOGR, int LOGS, bool INV, bool TOUT>
__global__ void __launch_bounds__(kThreads)
colpass_kernel(const uint32_t* __restrict__ x, const Tw* __restrict__ tabs,
               const Tw* __restrict__ pre, const Tw* __restrict__ post,
               uint32_t* __restrict__ y, int ncols, int has_pre,
               int has_post, uint32_t p) {
  constexpr int R = 1 << LOGR, S = 1 << LOGS, NN = R * S;
  // Phase A runs the R-point DIF (forward) or the S-point DIT (inverse).
  constexpr int LOGA = INV ? LOGS : LOGR;
  constexpr int LOGB = INV ? LOGR : LOGS;
  constexpr int NA = 1 << LOGA, NB = 1 << LOGB;
  constexpr int kPer = NN * kCols / kThreads;  // tile elements per thread
  constexpr int kChunk = 16;
  static_assert(kPer % kChunk == 0, "tile must split into chunks");

  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;
  Tw* stw = reinterpret_cast<Tw*>(smem + NN * kCols);
  const Tw* wmid = tabs + (NA - 1) + (NB - 1);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const size_t b = blockIdx.y;

  for (int i = tid; i < (NA - 1) + (NB - 1); i += kThreads)
    stw[i] = ldtw(tabs, i);

  // ---- load: coalesced 64-byte row segments, kChunk loads in flight
  // per thread before any is used ----
  const uint32_t* xb = x + b * NN * ncols + c0;
  for (int b0 = 0; b0 < kPer; b0 += kChunk) {
    uint32_t buf[kChunk];
    Tw tp[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int it = tid + (b0 + k) * kThreads;
      const int row = it >> 4, col = it & 15;
      buf[k] = xb[(size_t)row * ncols + col];
      if (has_pre) tp[k] = ldtw(pre, row * ncols + c0 + col);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int it = tid + (b0 + k) * kThreads;
      const int row = it >> 4, col = it & 15;
      uint32_t v = has_pre ? mulc(buf[k], tp[k], p) : buf[k];
      const int L = INV ? ((row & (R - 1)) << LOGS) + (row >> LOGR) : row;
      tile[phys<LOGS>(L, col)] = v;
    }
  }
  __syncthreads();

  const int col = tid & 15;
  const int g0 = tid >> 4;

  // ---- phase A ----
  if (!INV) {
    for (int s = g0; s < S; s += kThreads / kCols) {
      uint32_t v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = tile[phys<LOGS>(r * S + s, col)];
      dif<LOGR>(v, stw, p);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int L = r * S + s;
        tile[phys<LOGS>(L, col)] = mulc(v[r], ldtw(wmid, L), p);
      }
    }
  } else {
    for (int r = g0; r < R; r += kThreads / kCols) {
      uint32_t v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = tile[phys<LOGS>(r * S + s, col)];
      dit<LOGS>(v, stw, p);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int L = r * S + s;
        tile[phys<LOGS>(L, col)] = mulc(v[s], ldtw(wmid, L), p);
      }
    }
  }
  __syncthreads();

  // ---- phase B ----
  if (!INV) {
    for (int r = g0; r < R; r += kThreads / kCols) {
      uint32_t v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = tile[phys<LOGS>(r * S + s, col)];
      dif<LOGS>(v, stw + (NA - 1), p);
#pragma unroll
      for (int s = 0; s < S; ++s) tile[phys<LOGS>(r * S + s, col)] = v[s];
    }
  } else {
    for (int s = g0; s < S; s += kThreads / kCols) {
      uint32_t v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = tile[phys<LOGS>(r * S + s, col)];
      dit<LOGR>(v, stw + (NA - 1), p);
#pragma unroll
      for (int r = 0; r < R; ++r) tile[phys<LOGS>(r * S + s, col)] = v[r];
    }
  }
  __syncthreads();

  // ---- store: TOUT writes (batch, cols, nn), 16 consecutive rows j of
  // a column pair per warp; otherwise (batch, nn, cols). 64-byte
  // segments either way, kChunk twiddle loads in flight per thread ----
  uint32_t* yb = TOUT ? y + (b * ncols + c0) * NN : y + b * NN * ncols + c0;
  for (int b0 = 0; b0 < kPer; b0 += kChunk) {
    uint32_t buf[kChunk];
    Tw tq[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      int j, c;
      store_coords<TOUT>(tid + (b0 + k) * kThreads, j, c);
      const int L = INV ? j : ((j & (R - 1)) << LOGS) + (j >> LOGR);
      buf[k] = tile[phys<LOGS>(L, c)];
      if (has_post)
        tq[k] = ldtw(post, TOUT ? (c0 + c) * NN + j : j * ncols + c0 + c);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      int j, c;
      store_coords<TOUT>(tid + (b0 + k) * kThreads, j, c);
      const uint32_t v = has_post ? mulc(buf[k], tq[k], p) : buf[k];
      if (TOUT)
        yb[(size_t)c * NN + j] = v;
      else
        yb[(size_t)j * ncols + c] = v;
    }
  }
}

template <int LOGR, int LOGS, bool INV, bool TOUT>
cudaError_t launch(cudaStream_t stream, const uint32_t* x, const Tw* tabs,
                   const Tw* pre, const Tw* post, uint32_t* y, int batch,
                   int ncols, int has_pre, int has_post, uint32_t p) {
  constexpr int NN = 1 << (LOGR + LOGS);
  constexpr int NTW = (1 << LOGR) - 1 + (1 << LOGS) - 1;
  const size_t smem = NN * kCols * sizeof(uint32_t) + NTW * sizeof(Tw);
  auto kern = colpass_kernel<LOGR, LOGS, INV, TOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(ncols / kCols, batch);
  kern<<<grid, kThreads, smem, stream>>>(x, tabs, pre, post, y, ncols,
                                         has_pre, has_post, p);
  return cudaGetLastError();
}

template <int LOGR, int LOGS>
cudaError_t dispatch_dir(bool inv, bool tout, cudaStream_t st,
                         const uint32_t* x, const Tw* tabs, const Tw* pre,
                         const Tw* post, uint32_t* y, int batch, int ncols,
                         int has_pre, int has_post, uint32_t p) {
  if (inv)
    return tout ? launch<LOGR, LOGS, true, true>(st, x, tabs, pre, post, y,
                                                 batch, ncols, has_pre,
                                                 has_post, p)
                : launch<LOGR, LOGS, true, false>(st, x, tabs, pre, post, y,
                                                  batch, ncols, has_pre,
                                                  has_post, p);
  return tout ? launch<LOGR, LOGS, false, true>(st, x, tabs, pre, post, y,
                                                batch, ncols, has_pre,
                                                has_post, p)
              : launch<LOGR, LOGS, false, false>(st, x, tabs, pre, post, y,
                                                 batch, ncols, has_pre,
                                                 has_post, p);
}

ffi::Error ColpassImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                       ffi::Buffer<ffi::U32> tabs, ffi::Buffer<ffi::U32> pre,
                       ffi::Buffer<ffi::U32> post,
                       ffi::ResultBuffer<ffi::U32> y, int64_t logr,
                       int64_t logs, int64_t inverse, int64_t transpose_out,
                       int64_t has_pre, int64_t has_post, int64_t p) {
  auto dims = x.dimensions();
  if (dims.size() != 3)
    return ffi::Error::InvalidArgument("ntt_colpass: x must be 3-D");
  const int64_t batch = dims[0], nn = dims[1], ncols = dims[2];
  if (nn != (int64_t(1) << (logr + logs)))
    return ffi::Error::InvalidArgument("ntt_colpass: rows != 2^(logr+logs)");
  if (ncols % kCols != 0 || batch < 1 || batch > 65535)
    return ffi::Error::InvalidArgument("ntt_colpass: bad batch or cols");
  auto xd = x.typed_data();
  auto td = reinterpret_cast<const Tw*>(tabs.typed_data());
  auto pd = reinterpret_cast<const Tw*>(pre.typed_data());
  auto qd = reinterpret_cast<const Tw*>(post.typed_data());
  auto yd = y->typed_data();
  const bool inv = inverse != 0, tout = transpose_out != 0;
  const int b = (int)batch, c = (int)ncols, hp = (int)has_pre,
            hq = (int)has_post;
  const uint32_t pp = (uint32_t)p;
  cudaError_t err;
  if (logr == 4 && logs == 4)
    err = dispatch_dir<4, 4>(inv, tout, stream, xd, td, pd, qd, yd, b, c,
                             hp, hq, pp);
  else if (logr == 4 && logs == 5)
    err = dispatch_dir<4, 5>(inv, tout, stream, xd, td, pd, qd, yd, b, c,
                             hp, hq, pp);
  else if (logr == 5 && logs == 5)
    err = dispatch_dir<5, 5>(inv, tout, stream, xd, td, pd, qd, yd, b, c,
                             hp, hq, pp);
  else if (logr == 5 && logs == 6)
    err = dispatch_dir<5, 6>(inv, tout, stream, xd, td, pd, qd, yd, b, c,
                             hp, hq, pp);
  else
    return ffi::Error::InvalidArgument("ntt_colpass: unsupported column size");
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("ntt_colpass: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(NttColpass, ColpassImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()  // x
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tables
                                  .Arg<ffi::Buffer<ffi::U32>>()  // pre
                                  .Arg<ffi::Buffer<ffi::U32>>()  // post
                                  .Ret<ffi::Buffer<ffi::U32>>()  // y
                                  .Attr<int64_t>("logr")
                                  .Attr<int64_t>("logs")
                                  .Attr<int64_t>("inverse")
                                  .Attr<int64_t>("transpose_out")
                                  .Attr<int64_t>("has_pre")
                                  .Attr<int64_t>("has_post")
                                  .Attr<int64_t>("p"));
