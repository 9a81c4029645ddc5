// Fused LSTM inference step for Hopper (sm_90a), in two routes.
//
// Replaces the Pallas TPU kernel r2d2_tpu/ops/lstm.py:_fwd_infer_kernel
// (built by make_lstm_infer, called from models/network.py:LSTMLayer).
// Same function: per step t
//     gates = xp[t] + round_cd(h) @ wh        (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//     c' = f * c + i * g ;  h' = o * tanh(c')
// with h and c in f32 throughout and no rounding of the gate product to
// the compute dtype (the Pallas kernel's numerics, one rounding fewer than
// the scan in models/network.py).  T > 1 is a loop of one-step launches
// from the C entry points: stream order carries h from hs[t-1] to step t,
// and c is updated in place (each (b, j) element has one owning thread).
//
// Bound on the H100: the main path runs T = 1, H = 512, B <= 256 (the
// served act, acting, evaluation).  A step must move wh (2 MiB in bf16)
// plus xp (B x 2048 x 4 bytes) and does 2*B*H*4H flops, at most about
// 60 operations per byte, far below the ~295 the card needs to be
// compute-bound: it is bound by bytes.
//
// Tensor-core route (bf16 wh, lstm_step_wgmma): one step is a skinny GEMM
// M = B, N = 4H, K = H with the LSTM cell fused into its epilogue.  A
// block owns n hidden units with all four of their gates (the strips of
// wh at columns j0, H+j0, 2H+j0, 3H+j0) and one row tile of 64 batch rows
// (one wgmma M), so the cell needs nothing from another block.  What the
// CUDA-core design lost time on, and what this one does instead:
//   1. few blocks at small B (16 blocks for B <= 8): here the grid is
//      (H/n) x ceil(B/64) with n = 8 at small B, so 64 blocks share wh;
//   2. wh re-read for every 8 batch rows (64 MiB of L2 reads at B = 256):
//      here once per 64-row tile, 2 MiB x ceil(B/64);
//   3. one 2-byte load per lane: here TMA brings each strip into shared
//      memory as 2-D boxes of n x 64 (four per K stage, one mbarrier per
//      stage), every stage in flight at once while the threads load h;
//   4. f32 FMAs on the CUDA cores: here wgmma.mma_async m64(4n)k16, bf16
//      in and f32 out, so each thread ends up holding the same units of
//      all four gates in registers, and the epilogue reads xp and c,
//      applies the cell and writes h and c without leaving registers.
// wh stays (K, N) row-major as the caller gives it (it is re-cast per act,
// so its address can change: the tensor map is encoded on the host
// whenever it does), which makes the B operand MN-major.  The box is n elements wide, and the
// swizzle is the one whose span is n * 2 bytes (none or 32 B for n = 8 or
// 16), so one swizzle atom holds a gate's strip and the four
// strips are four atoms along N.  h is read as f32 (coalesced, 32 bytes
// a thread per load pair), rounded to bf16 once and stored as the A
// operand, K-major with the 128-byte swizzle.  Loading h is the part of a
// step that grows with B, so a block has two warpgroups: both load h, the
// first then runs the products and the cell.  All of a block's K is in
// shared memory at once (one mbarrier per 64-row stage, no ring to
// recycle).  Rows past B are never loaded or written; K past H is
// zero on both sides (TMA's out-of-bounds fill for wh, explicit for h);
// units past H (a ragged last tile) are computed on neighbouring columns
// and dropped.  When H % 8 != 0 some strips start off a 16-byte boundary,
// which TMA cannot address: those blocks load 16-wide boxes from the
// boundary below and copy the strips into place (kRaggedBox).  No H that
// the repo's configurations use is ragged in that way.
//
// CUDA-core route (f32 wh, lstm_step_cudacore; also bf16 for comparison):
// the first design, kept because tensor cores have no exact f32 product
// (TF32 keeps 10 bits).  One block per 32 output columns x 8 batch rows;
// 8 warps split K and load 8 rows of wh at a time from L2; f32 FMAs.
//
// The plain C interface is loaded with ctypes (r2d2_tpu_torch/ops/_build.py);
// the Python wrapper (ops/lstm.py) validates devices, dtypes, shapes,
// contiguity and alignment and picks the tile plan before passing pointers.

#include <cuda.h>   // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

// ----------------------------------------------------------------------
// CUDA-core route
// ----------------------------------------------------------------------

constexpr int kCols = 32;   // output columns per block: one per lane
constexpr int kWarps = 8;   // the K reduction is split across the warps
constexpr int kRows = 8;    // batch rows per block
constexpr int kUnroll = 8;  // wh rows loaded together per warp
constexpr int kRowsPerWarp = kRows / kWarps;
static_assert(kRows % kWarps == 0, "each warp finishes whole rows");

__device__ __forceinline__ float load_w(const float* w, size_t i) {
  return w[i];
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}

// h.astype(compute_dtype) of the Pallas kernel, widened back for the f32
// multiply (a bf16 x bf16 product is exact in f32)
__device__ __forceinline__ float round_h(float x, const float*) { return x; }

__device__ __forceinline__ float round_h(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename WT>
__global__ void __launch_bounds__(kCols * kWarps)
    lstm_step_cudacore(const float* __restrict__ xp,    // (B, 4H), step t
                       const WT* __restrict__ wh,       // (H, 4H)
                       const float* __restrict__ h_in,  // (B, H)
                       float* __restrict__ c,           // (B, H), in place
                       float* __restrict__ h_out,       // (B, H) = hs[t]
                       int B, int H) {
  // h_sm holds the block's h rows during the K loop; once every warp is
  // past it, the same shared memory holds the warps' partial sums
  extern __shared__ float smem[];
  float* h_sm = smem;                  // [kRows][H]
  float* part = smem;                  // [kWarps][kRows][4][kCols]

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int j = blockIdx.x * kCols + lane;
  const int b0 = blockIdx.y * kRows;
  const int nr = min(kRows, B - b0);
  const size_t H4 = 4 * static_cast<size_t>(H);

  for (int i = tid; i < kRows * H; i += kCols * kWarps) {
    const int r = i / H;
    const int k = i - r * H;
    h_sm[i] = r < nr ? round_h(h_in[static_cast<size_t>(b0 + r) * H + k], wh)
                     : 0.0f;
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  }
  if (j < H) {
    const int k_per = (H + kWarps - 1) / kWarps;
    const int k0 = warp * k_per;
    const int k1 = min(H, k0 + k_per);
    const WT* w = wh + static_cast<size_t>(k0) * H4 + j;
    int k = k0;
    // kUnroll rows of wh in flight per warp: the loads of a chunk are
    // issued together, so a warp waits on L2 once per chunk, not per row
    for (; k + kUnroll <= k1; k += kUnroll, w += kUnroll * H4) {
      float wv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wv[u][g] = load_w(w, u * H4 + static_cast<size_t>(g) * H);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = h_sm[r * H + k + u];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[r][g] = fmaf(hv, wv[u][g], acc[r][g]);
          }
        }
      }
    }
    for (; k < k1; ++k, w += H4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = h_sm[r * H + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = fmaf(hv, load_w(w, static_cast<size_t>(g) * H),
                           acc[r][g]);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with h_sm: reuse it for part
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      part[((warp * kRows + r) * 4 + g) * kCols + lane] = acc[r][g];
    }
  }
  __syncthreads();

  if (j >= H) return;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nr) continue;
    const size_t b = static_cast<size_t>(b0 + r);
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += part[((w * kRows + r) * 4 + g) * kCols + lane];
      }
      gate[g] = xp[b * H4 + static_cast<size_t>(g) * H + j] + s;
    }
    const float si = sigmoid_f(gate[0]);
    const float sf = sigmoid_f(gate[1]);
    const float tg = tanhf(gate[2]);
    const float so = sigmoid_f(gate[3]);
    const size_t idx = b * H + j;
    const float c_new = sf * c[idx] + si * tg;
    c[idx] = c_new;
    h_out[idx] = so * tanhf(c_new);
  }
}

// shared memory of one block: the h tile, later reused for the partials
constexpr size_t kPartFloats = static_cast<size_t>(kWarps) * kRows * 4 * kCols;

size_t cudacore_smem_floats(int H) {
  const size_t tile = static_cast<size_t>(kRows) * H;
  return tile > kPartFloats ? tile : kPartFloats;
}

template <typename WT>
cudaError_t run_cudacore(const float* xp, const WT* wh, const float* h0,
                         float* c, float* hs, int T, int B, int H,
                         cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  const dim3 grid((H + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * cudacore_smem_floats(H);
  const size_t step_in = static_cast<size_t>(B) * 4 * H;
  const size_t step_out = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : hs + (t - 1) * step_out;
    lstm_step_cudacore<WT><<<grid, block, smem, stream>>>(
        xp + t * step_in, wh, h_in, c, hs + t * step_out, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ----------------------------------------------------------------------
// Tensor-core route
// ----------------------------------------------------------------------

constexpr int kRowTile = 64;    // batch rows per block: one wgmma M
constexpr int kBK = 64;         // K rows per TMA stage: one 128-byte A row
// warpgroup 0 runs the products and the cell; every warpgroup helps to
// load h, the one part of a step whose instructions grow with B
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kMaxSmem = 232448;
constexpr int kAlign = 1024;    // slack to align the dynamic shared memory

// A gate's strip starts at column g*H + j0, which TMA can only address
// on a 16-byte boundary: when H % 8 != 0 (H = 100 say) the strips of some
// gates do not.  Then n = 8, each strip comes in as a 16-wide box from
// the boundary below it, and the threads copy its 8 columns into place.
constexpr int kRaggedBox = 16;

__host__ __device__ constexpr bool ragged_gates(int H) { return H % 8 != 0; }

// K = H padded to whole stages
__host__ __device__ constexpr int padded_k(int H) {
  return (H + kBK - 1) / kBK * kBK;
}

// Shared memory of one block, in bytes, for n units per gate and kp
// (padded_k) K rows: the wh strips (4 gates x n x kp bf16), the boxes they
// are copied from when the gates are ragged (4 x 16 x kp bf16), the A tile
// (64 x kp bf16), one mbarrier per stage.  ops/lstm.py:launch_plan
// computes the same number.
constexpr size_t wgmma_smem_bytes(int n, int kp, bool ragged) {
  return kAlign + 8 * static_cast<size_t>(n) * kp +
         (ragged ? 8 * static_cast<size_t>(kRaggedBox) * kp : 0) +
         2 * static_cast<size_t>(kRowTile) * kp + 8 * (kp / kBK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// The poll loop stays inside the asm, where the compiler sees no branch
// that could split the warpgroup (a visible one makes it serialize the
// wgmma that follow).  A TMA that never completes traps (a launch error
// the wrapper reports) after 2^24 polls, seconds, instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 polls;\nmov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.lt.u32 p, polls, 16777216;\n"
      "@p bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one 2-D box of wh (x = column, y = row) into shared memory, completion
// counted in bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (0 none, 1 128 B, 2 64 B,
// 3 32 B swizzle); base offset 0, every atom starts aligned
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The B operand's layout for n units per gate: the swizzle whose span is
// one strip row (n * 2 bytes).  For MN-major operands a swizzled layout
// takes LBO = stride between atoms along N (here: between gate strips)
// and SBO = stride between 8-row groups along K; the no-swizzle layout
// takes them the other way round.
template <int N>
struct BLayout;
template <>
struct BLayout<8> {
  static constexpr uint32_t kLayout = 0;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  __device__ static uint64_t desc(const void* p, uint32_t strip) {
    return smem_desc(p, 8 * 16, strip, kLayout);
  }
};
template <>
struct BLayout<16> {
  static constexpr uint32_t kLayout = 3;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
  __device__ static uint64_t desc(const void* p, uint32_t strip) {
    return smem_desc(p, strip, 8 * 32, kLayout);
  }
};
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)

// D (64 x 4n, f32) += A (64 x 16, bf16, K-major) * B (16 x 4n, bf16,
// MN-major): scale-d 1, scale-a/b 1, transpose-a 0, transpose-b 1
template <int NT>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : ACC16(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : ACC16(0), ACC16(16)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC16
#undef ACC4

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int N,        // hidden units per gate per block: 8 or 16
          bool Ragged>  // H % 8 != 0: strips copied into place (N == 8)
__global__ void __launch_bounds__(kThreads)
    lstm_step_wgmma(const __grid_constant__ CUtensorMap wh_map,  // (H, 4H)
                    const float* __restrict__ xp,    // (B, 4H), step t
                    const float* __restrict__ h_in,  // (B, H)
                    float* __restrict__ c,           // (B, H), in place
                    float* __restrict__ h_out,       // (B, H) = hs[t]
                    int B, int H) {
  static_assert(!Ragged || N == 8, "ragged gates are copied at n = 8");
  constexpr int NT = 4 * N;        // the wgmma N: four gates of N units
  constexpr int kStrip = 2 * N;    // bytes per strip row
  constexpr uint32_t strip = kStrip * kBK;          // one gate, one stage
  constexpr uint32_t box = Ragged ? 2 * kRaggedBox * kBK : strip;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  const int kp = padded_k(H);
  const int stages = kp / kBK;
  uint8_t* b_sm = smem;                             // [stages][4][64][N]
  uint8_t* box_sm = b_sm + 4 * strip * stages;      // [stages][4][64][16]
  uint8_t* a_sm = box_sm + (Ragged ? 4 * box * stages : 0);  // [stages][64][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(a_sm + 2 * kRowTile * kp);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * N;
  const int b0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, B - b0);

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&wh_map))
                 : "memory");
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // every stage in flight at once; the block's whole K fits
    uint8_t* dst = Ragged ? box_sm : b_sm;
    for (int s = 0; s < stages; ++s) {
      mbar_expect_tx(&bars[s], 4 * box);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        tma_load_2d(dst + (s * 4 + g) * box, &wh_map, (g * H + j0) & ~7,
                    s * kBK, &bars[s]);
      }
    }
  }

  // the warpgroup index, read through a shuffle so that the compiler knows
  // it is uniform across the warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  // The epilogue's operands, loaded now (by warpgroup 0) so that their
  // latency hides behind the copies and the products.  Accumulator
  // register 4*J + 2*half + e of thread (warp w, lane l) is row
  // 16w + l/4 + 8*half, column 8J + 2*(l%4) + e, and column g*N + u is
  // unit j0 + u of gate g: each thread owns two rows and N/4 units of all
  // four gates.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t H4 = 4 * static_cast<size_t>(H);
  float xv[2][N / 8][2][4];
  float cv[2][N / 8][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + half * 8;
    const size_t b = static_cast<size_t>(b0 + r);
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + jj * 8 + (lane % 4) * 2 + e;
        const bool own = wg == 0 && r < nr && j < H;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          xv[half][jj][e][g] =
              own ? xp[b * H4 + static_cast<size_t>(g) * H + j] : 0.0f;
        }
        cv[half][jj][e] = own ? c[b * H + j] : 0.0f;
      }
    }
  }

  // A: the block's h rows rounded to bf16, K-major with the 128-byte
  // swizzle: stage s holds K columns 64s.. as 64 rows of 128 bytes, and
  // the 16-byte chunk q of row r sits at chunk q ^ (r % 8).  A thread
  // takes 8 floats of one row at a time and writes them as one chunk;
  // consecutive threads take consecutive chunks, so a warp reads 1 KiB of
  // a row and writes whole 128-byte rows.  Rows past B stay unwritten:
  // each output row depends on its own A row only, and those rows are
  // dropped.
  {
    const int kc = kp / 8;   // chunks per A row
    const int items = nr * kc;
    const bool vec =
        (H & 3) == 0 && (reinterpret_cast<uintptr_t>(h_in) & 15) == 0;
    constexpr int U = 8;     // chunks in flight per thread
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = tid; base < items; base += kThreads * U) {
      float4 v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kThreads;
        const int r = i / kc;
        const int k = (i - r * kc) * 8;
        const float* row = h_in + static_cast<size_t>(b0 + r) * H + k;
        const bool in = i < items;
        if (vec) {   // H % 4 == 0: a float4 is all in or all past H
          v[u][0] = in && k < H ? *reinterpret_cast<const float4*>(row)
                                : zero;
          v[u][1] = in && k + 4 < H
                        ? *reinterpret_cast<const float4*>(row + 4) : zero;
        } else {
          float* f = reinterpret_cast<float*>(v[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = in && k + e < H ? row[e] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kThreads;
        if (i >= items) break;
        const int r = i / kc;
        const int k = (i - r * kc) * 8;
        const int q = (k & (kBK - 1)) >> 3;
        *reinterpret_cast<uint4*>(a_sm + (k / kBK) * (kRowTile * 128) +
                                  r * 128 + ((q ^ (r & 7)) << 4)) =
            make_uint4(pack_bf16x2(v[u][0].x, v[u][0].y),
                       pack_bf16x2(v[u][0].z, v[u][0].w),
                       pack_bf16x2(v[u][1].x, v[u][1].y),
                       pack_bf16x2(v[u][1].z, v[u][1].w));
      }
    }
  }
  if constexpr (Ragged) {
    // each box row holds the strip's 8 columns from offset (g*H+j0) % 8,
    // an even count of bf16, so they are read as four aligned words
    for (int s = 0; s < stages; ++s) {
      mbar_wait(&bars[s], 0);
      for (int i = tid; i < 4 * kBK; i += kThreads) {
        const int g = i / kBK;
        const int y = i - g * kBK;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            box_sm + (s * 4 + g) * box + y * 2 * kRaggedBox +
            2 * ((g * H + j0) & 7));
        *reinterpret_cast<uint4*>(b_sm + (s * 4 + g) * strip + y * kStrip) =
            make_uint4(src[0], src[1], src[2], src[3]);
      }
    }
  }
  // the generic-proxy stores must be visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (wg != 0) return;

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < stages; ++s) {
    mbar_wait(&bars[s], 0);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 128-byte swizzle, SBO = next 8 rows (1024 B), a k16 step is 32
      // bytes into the row; B: one strip per gate (BLayout)
      const uint64_t da =
          smem_desc(a_sm + s * (kRowTile * 128) + kk * 32, 16, 1024, 1);
      const uint64_t db =
          BLayout<N>::desc(b_sm + s * 4 * strip + kk * 16 * kStrip, strip);
      Wgmma<NT>::mma(acc, da, db);
    }
    wgmma_commit();
    fence_acc(acc);
  }
  wgmma_wait_all();
  fence_acc(acc);

  // the cell, from registers: the four gates of a unit are in one thread
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + half * 8;
    if (r >= nr) continue;
    const size_t b = static_cast<size_t>(b0 + r);
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + jj * 8 + (lane % 4) * 2 + e;
        if (j >= H) continue;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gate[g] = acc[4 * (g * (N / 8) + jj) + 2 * half + e] +
                    xv[half][jj][e][g];
        }
        const float si = sigmoid_f(gate[0]);
        const float sf = sigmoid_f(gate[1]);
        const float tg = tanhf(gate[2]);
        const float so = sigmoid_f(gate[3]);
        const size_t idx = b * H + j;
        const float c_new = sf * cv[half][jj][e] + si * tg;
        c[idx] = c_new;
        h_out[idx] = so * tanhf(c_new);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (the
// library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes of the tensor-core entry point that are not cudaError_t
constexpr int kNoEncoder = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int kBadMap = -2;      // it refused the tensor map

// The dynamic shared memory above 48 KB is an opt-in of each device: set
// once per (kernel instance, device) that launches it.
constexpr int kMaxDevices = 64;

template <int N, bool Ragged>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(lstm_step_wgmma<N, Ragged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

// The tensor map of wh: x = column (4H), y = row (H); one box is one
// gate's strip of N columns (16 when the gates are ragged) by 64 rows;
// rows past H and columns past 4H read as zeros.  It depends only on the
// address and H, so the last one encoded is kept per thread and reused
// while the caller passes the same wh (the served act's cast lands at the
// same address from act to act).
template <int N, bool Ragged>
int wh_tensor_map(const __nv_bfloat16* wh, int H, CUtensorMap* out) {
  struct Cached {
    const void* ptr = nullptr;
    int H = 0;
    CUtensorMap map;
  };
  thread_local Cached last;
  if (last.ptr == wh && last.H == H) {
    *out = last.map;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {4 * static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[1] = {8 * static_cast<cuuint64_t>(H)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Ragged ? kRaggedBox : N),
                             static_cast<cuuint32_t>(kBK)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(wh),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      BLayout<N>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kBadMap;
  last.ptr = wh;
  last.H = H;
  last.map = *out;
  return 0;
}

template <int N, bool Ragged>
int run_wgmma(const float* xp, const __nv_bfloat16* wh, const float* h0,
              float* c, float* hs, int T, int B, int H, dim3 grid,
              cudaStream_t stream) {
  const cudaError_t set = allow_smem<N, Ragged>();
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap map;
  const int enc = wh_tensor_map<N, Ragged>(wh, H, &map);
  if (enc != 0) return enc;

  const size_t smem = wgmma_smem_bytes(N, padded_k(H), Ragged);
  const size_t step_in = static_cast<size_t>(B) * 4 * H;
  const size_t step_out = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : hs + (t - 1) * step_out;
    lstm_step_wgmma<N, Ragged><<<grid, kThreads, smem, stream>>>(
        map, xp + t * step_in, h_in, c, hs + t * step_out, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Largest H whose CUDA-core shared-memory tile fits the default 48 KB.
extern "C" int lstm_infer_max_hidden() {
  return 48 * 1024 / static_cast<int>(sizeof(float)) / kRows;
}

// Shared memory the tensor-core route asks for at (n, H), so the
// wrapper's launch_plan can be checked against the kernel's own count.
extern "C" long long lstm_infer_wgmma_smem(int n, int H) {
  return static_cast<long long>(
      wgmma_smem_bytes(n, padded_k(H), ragged_gates(H)));
}

// CUDA-core route.  xp (T, B, 4H) f32; wh (H, 4H) bf16 when wh_bf16 else
// f32; h0 (B, H) f32; c (B, H) f32 holding c0 on entry and c_T on return;
// hs (T, B, H) f32.  Returns the cudaError_t of the first launch that
// failed, else 0.
extern "C" int lstm_infer_cudacore(const void* xp, const void* wh,
                                   int wh_bf16, const void* h0, void* c,
                                   void* hs, int T, int B, int H,
                                   void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > lstm_infer_max_hidden()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xp);
  const auto* h = static_cast<const float*>(h0);
  auto* cc = static_cast<float*>(c);
  auto* out = static_cast<float*>(hs);
  const cudaError_t err =
      wh_bf16 ? run_cudacore(x, static_cast<const __nv_bfloat16*>(wh), h, cc,
                             out, T, B, H, s)
              : run_cudacore(x, static_cast<const float*>(wh), h, cc, out, T,
                             B, H, s);
  return static_cast<int>(err);
}

// Tensor-core route, bf16 wh only; the same buffers as above.  n (units
// per gate per block: 8 or 16) and the grid come from
// ops/lstm.py:launch_plan; the grid must be the one that covers every
// (row, unit) once, (ceil(H/n), ceil(B/64)), and is refused otherwise.
// Also re-checked here: the TMA constraints (wh 16-byte aligned, its row
// stride 8H bytes a multiple of 16), n = 8 for ragged gates, and the
// shared-memory limit.  Returns 0, a cudaError_t, or one of the negative
// codes above.
extern "C" int lstm_infer_wgmma(const void* xp, const void* wh,
                                const void* h0, void* c, void* hs, int T,
                                int B, int H, int n, int grid_x, int grid_y,
                                void* stream) {
  const bool ragged = ragged_gates(H);
  if (T < 1 || B < 1 || H < 2 || H % 2 != 0 || n < 1 ||
      (reinterpret_cast<uintptr_t>(wh) & 15) != 0 || (ragged && n != 8) ||
      lstm_infer_wgmma_smem(n, H) > kMaxSmem ||
      grid_x != (H + n - 1) / n ||
      grid_y != (B + kRowTile - 1) / kRowTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xp);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  const auto* h = static_cast<const float*>(h0);
  auto* cc = static_cast<float*>(c);
  auto* out = static_cast<float*>(hs);
  if (ragged) return run_wgmma<8, true>(x, w, h, cc, out, T, B, H, grid, s);
  switch (n) {
    case 8: return run_wgmma<8, false>(x, w, h, cc, out, T, B, H, grid, s);
    case 16: return run_wgmma<16, false>(x, w, h, cc, out, T, B, H, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lstm_infer_error_string(int code) {
  if (code == kNoEncoder) {
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  }
  if (code == kBadMap) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
