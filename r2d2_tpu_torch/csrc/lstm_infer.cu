// Fused LSTM inference unroll for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel r2d2_tpu/ops/lstm.py:_fwd_infer_kernel
// (built by make_lstm_infer, called from models/network.py:LSTMLayer).
// Same function: per step t
//     gates = xp[t] + round_cd(h) @ wh        (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide slices
//     c' = f * c + i * g ;  h' = o * tanh(c')
// with h and c in f32 throughout and no rounding of the gate product to
// the compute dtype (the Pallas kernel's numerics, one rounding fewer than
// the scan in models/network.py).
//
// Design (first, simple version): one launch per time step, and inside a
// step one block per (32 output columns) x (8 batch rows).  Each of the
// block's 8 warps takes an eighth of the K = H reduction; a lane owns one
// output column j and accumulates the four gate dot products for the 8
// rows, loading 8 rows of wh at a time so a warp waits on L2 once per 8
// rows.  The 8 h rows, already rounded to the compute dtype, sit in shared
// memory and are read as broadcasts; wh is read coalesced, 32 consecutive
// columns per warp and gate.  The warps' partial sums meet in the same
// shared memory once the K loop is done.  Column j needs only its own four
// gate columns, so a step needs no grid-wide sync: stream order between
// the T launches carries h from hs[t-1] to step t.  c is updated in place:
// each (b, j) element is read and written by the same thread only.
//
// Bound on the H100: at serving shapes (T=1, B<=256, H=512) the kernel
// must move wh (2 MiB in bf16) plus xp (B x 2048 x 4 bytes) and does
// 2*B*H*4H flops, about 2 operations per byte, far below the ~295 the
// card needs to be compute-bound: it is bound by bytes.  This version
// re-reads wh once per block of 8 rows (from L2: 2 MiB stays resident in
// the 50 MB L2) and runs the products on the CUDA cores in f32.  A
// persistent single launch over all T with wh split across a thread-block
// cluster's shared memory, fed by TMA and multiplied with wgmma, is the
// faster design for a later change.
//
// The plain C interface is loaded with ctypes (r2d2_tpu_torch/ops/_build.py);
// the Python wrapper validates devices, dtypes, shapes and contiguity
// before passing pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
    lstm_step_kernel(const float* __restrict__ xp,    // (B, 4H), step t
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

size_t smem_floats(int H) {
  const size_t tile = static_cast<size_t>(kRows) * H;
  return tile > kPartFloats ? tile : kPartFloats;
}

template <typename WT>
cudaError_t run_unroll(const float* xp, const WT* wh, const float* h0,
                       float* c, float* hs, int T, int B, int H,
                       cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  const dim3 grid((H + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * smem_floats(H);
  const size_t step_in = static_cast<size_t>(B) * 4 * H;
  const size_t step_out = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : hs + (t - 1) * step_out;
    lstm_step_kernel<WT><<<grid, block, smem, stream>>>(
        xp + t * step_in, wh, h_in, c, hs + t * step_out, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Largest H whose shared-memory tile fits the default 48 KB per block.
extern "C" int lstm_infer_max_hidden() {
  return 48 * 1024 / static_cast<int>(sizeof(float)) / kRows;
}

// xp (T, B, 4H) f32; wh (H, 4H) bf16 when wh_bf16 else f32; h0 (B, H) f32;
// c (B, H) f32 holding c0 on entry and c_T on return; hs (T, B, H) f32.
// Returns the cudaError_t of the first launch that failed, else 0.
extern "C" int lstm_infer_forward(const void* xp, const void* wh, int wh_bf16,
                                  const void* h0, void* c, void* hs, int T,
                                  int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > lstm_infer_max_hidden()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xp);
  const auto* h = static_cast<const float*>(h0);
  auto* cc = static_cast<float*>(c);
  auto* out = static_cast<float*>(hs);
  const cudaError_t err =
      wh_bf16 ? run_unroll(x, static_cast<const __nv_bfloat16*>(wh), h, cc, out,
                           T, B, H, s)
              : run_unroll(x, static_cast<const float*>(wh), h, cc, out, T,
                           B, H, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
