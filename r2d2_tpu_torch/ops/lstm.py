"""Fused LSTM **inference** unroll: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``r2d2_tpu/ops/lstm.py`` (the Pallas ``_fwd_infer_kernel``).  The
kernel source is ``r2d2_tpu_torch/csrc/lstm_infer.cu``; its header says
what bounds it on the H100 and how it is laid out.

Shapes (time-major, as the Pallas call takes them):

- ``xp``: (T, B, 4H) float32 — hoisted input projection ``x @ wi + b``,
- ``wh``: (H, 4H) in ``compute_dtype`` (bfloat16 or float32),
- ``h0``/``c0``: (B, H) float32,
- returns ``hs`` (T, B, H) float32 and the finals ``h_T``, ``c_T``.

Numerics are the Pallas kernel's: ``h`` is rounded to ``compute_dtype``
before the recurrent product, the product accumulates in float32 and is
NOT rounded to ``compute_dtype`` (the scan in ``models/network.py`` does
round it), gate order i, f, g, o, and h/c stay float32.

Dispatch: :func:`lstm_unroll_infer` launches the CUDA kernel for tensors
on a CUDA device and runs :func:`lstm_unroll_reference` for tensors on the
CPU.  On the card, ``wh``'s dtype picks the route: bf16 goes to the
tensor-core kernel (TMA and ``wgmma``, tiled by :func:`launch_plan`), f32
to the f32 kernel (TMA, h multicast across a cluster, f32 FMAs, tiled by
:func:`f32_plan`).  The first CUDA-core design (:func:`_lstm_unroll_pr1`)
stays only as the comparison column of the card's timings.  A CUDA input
that the kernel cannot take raises;
nothing falls back to the plain version.  The unroll is not
differentiable (the reference retired its backward kernel): ``backward``
raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch

from r2d2_tpu_torch.utils.trace import KERNEL_LAUNCHES, TransferCounter

Unroll = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

KERNEL = "lstm_infer"


def _check(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
           c0: torch.Tensor) -> None:
    if xp.dim() != 3 or xp.shape[0] < 1 or xp.shape[1] < 1:
        raise ValueError(f"xp must be (T>=1, B>=1, 4H), got {tuple(xp.shape)}")
    T, B, H4 = xp.shape
    if H4 % 4:
        raise ValueError(f"xp's last dim {H4} is not 4H")
    H = H4 // 4
    if tuple(wh.shape) != (H, H4):
        raise ValueError(f"wh must be {(H, H4)}, got {tuple(wh.shape)}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"{name} must be {(B, H)}, got {tuple(t.shape)}")
    if xp.dtype != torch.float32:
        raise TypeError(f"xp must be float32, got {xp.dtype}")
    if wh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wh must be float32 or bfloat16, got {wh.dtype}")


def lstm_unroll_reference(xp: torch.Tensor, wh: torch.Tensor,
                          h0: torch.Tensor, c0: torch.Tensor,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Unroll:
    """Plain PyTorch loop with the kernel's semantics.  The recurrent
    product is an f32 matmul of operands already rounded to
    ``compute_dtype`` — exact products, f32 sums, no output rounding.  On a
    CUDA device the caller turns TF32 off for it to mean f32."""
    _check(xp, wh, h0, c0)
    H = h0.shape[1]
    w = wh.to(compute_dtype).float()
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(xp.shape[0]):
        gates = xp[t] + h.to(compute_dtype).float() @ w
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), h, c


# the tensor-core route's tiles (csrc/lstm_infer.cu): one wgmma M of batch
# rows per block, at most the card's shared memory per block
ROW_TILE = 64
STAGE_K = 64
MAX_SMEM = 232_448
_SMEM_ALIGN = 1024
_RAGGED_BOX = 16
UNITS_PER_GATE = (8, 16)

# KERNEL_LAUNCHES names: the tensor-core kernel counts under KERNEL, the
# f32 route's kernel (lstm_step_f32) under CUDACORE_COUNTER, the first
# CUDA-core design (lstm_step_cudacore, kept for comparison) under
# PR1_COUNTER
CUDACORE_COUNTER = f"{KERNEL}_cudacore"
PR1_COUNTER = f"{KERNEL}_cudacore_pr1"

# the f32 route's tiles (csrc/lstm_infer.cu:lstm_step_f32): 32 K rows a
# stage (one 128-byte swizzled h row), boxes at least 16 bytes wide, at
# most 512 threads and 16 K groups a block, and grids of at least this
# many blocks where the units allow.  Chosen from a sweep of every tile
# on the H100 (PERF.md §6, PR 15): the most units a block that keeps 64
# blocks, 8-row tiles up to B = 32, clusters of 2 (clusters of 4 or 8
# over blocks of 100 KB and more doubled the time)
F32_STAGE_K = 32
F32_UNITS = (1, 2, 4, 8, 16)
F32_ROW_TILES = (8, 16, 32, 64)
F32_MAX_THREADS = 512
F32_MAX_GROUPS = 16
F32_TARGET_BLOCKS = 64
F32_CLUSTER = 2

# The C side keeps the last tensor map it encoded for ``wh``, one per
# thread and kernel instantiation (n, ragged gates), keyed on wh's address
# and H (``csrc/lstm_infer.cu:wh_tensor_map``).  This mirror of that rule
# counts the encodes the tensor-core launches pay, under KERNEL: a stack
# of layers acting in turn re-encodes on every launch.
TENSOR_MAP_ENCODES = TransferCounter()
_tensor_maps = threading.local()


def _note_tensor_map(wh: torch.Tensor, n: int) -> None:
    H = wh.shape[0]
    cache = getattr(_tensor_maps, "last", None)
    if cache is None:
        cache = _tensor_maps.last = {}
    key, entry = (n, H % 8 != 0), (wh.data_ptr(), H)
    if cache.get(key) != entry:
        cache[key] = entry
        TENSOR_MAP_ENCODES.count(KERNEL)


class LaunchPlan(NamedTuple):
    """Tiles of one tensor-core step: ``n`` hidden units (of all four
    gates) per block, the grid (hidden tiles, 64-row tiles) that the C
    entry point launches (it refuses any other), and the block's dynamic
    shared memory in bytes."""
    n: int
    grid: Tuple[int, int]
    smem_bytes: int


def _smem_bytes(n: int, H: int) -> int:
    # the kernel's count (lstm_infer.cu:wgmma_smem_bytes): alignment slack,
    # 4 gates x n x kp bf16 of wh, the 16-wide boxes they are copied from
    # when H % 8 != 0, 64 x kp bf16 of h, one mbarrier a stage
    kp = -(-H // STAGE_K) * STAGE_K
    boxes = 8 * _RAGGED_BOX * kp if H % 8 else 0
    return (_SMEM_ALIGN + 8 * n * kp + boxes + 2 * ROW_TILE * kp
            + 8 * (kp // STAGE_K))


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int) -> LaunchPlan:
    """The tensor-core route's tiles for batch ``B`` and hidden size ``H``
    (cached: the served act asks once per bucket).

    Every block reads its four strips of wh once, so the L2 reads of wh
    are 2 MiB x ceil(B/64) at H=512 whatever ``n`` is; ``n`` trades the
    number of blocks against the reads of h (each block of a row tile
    reads the tile's h).  Up to two row tiles, n = 8 spreads wh over
    H/8 blocks per tile (64 at H=512) so small buckets still use many SMs;
    beyond that n = 16 halves the h reads.  When H % 8 != 0 the gate
    strips are copied into place in shared memory, which the kernel does
    at n = 8 only.  ``n`` shrinks if the block's shared memory would not
    fit; a hidden size that does not fit even at n = 8 raises."""
    if B < 1 or H < 1:
        raise ValueError(f"launch_plan needs B, H >= 1, got B={B} H={H}")
    n = 8 if -(-B // ROW_TILE) <= 2 or H % 8 else 16
    while n > UNITS_PER_GATE[0] and _smem_bytes(n, H) > MAX_SMEM:
        n //= 2
    return plan_for(n, B, H)


def plan_for(n: int, B: int, H: int) -> LaunchPlan:
    """The plan at a given ``n``: the grid that covers (B, H) once, and
    the shared memory.  Raises when that does not fit a block."""
    smem = _smem_bytes(n, H)
    if smem > MAX_SMEM:
        raise ValueError(f"hidden size {H} needs {smem} bytes of shared-"
                         f"memory per block, more than {MAX_SMEM}")
    return LaunchPlan(n, (-(-H // n), -(-B // ROW_TILE)), smem)


class F32Plan(NamedTuple):
    """Tiles of one f32 step: ``n`` hidden units (of all four gates) per
    block, ``rows`` batch rows per block, ``rr`` of them per thread, ``ks``
    groups of threads that split K, the cluster that shares one h tile by
    multicast, the grid (hidden tiles, row tiles), the block's threads
    (``ks * n * rows / rr``) and its dynamic shared memory in bytes."""
    n: int
    rows: int
    rr: int
    ks: int
    cluster: int
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int


def _f32_smem_bytes(n: int, rows: int, H: int) -> int:
    # the kernel's count (lstm_infer.cu:f32_smem_bytes): alignment slack,
    # then per 32-row stage the swizzled h box (rows x 128 bytes), four wh
    # boxes (32 x max(n, 4) f32) and one mbarrier
    stages = -(-H // F32_STAGE_K)
    return _SMEM_ALIGN + stages * (rows * 128 + 4 * max(n, 4)
                                   * F32_STAGE_K * 4 + 8)


@functools.lru_cache(maxsize=None)
def f32_plan(B: int, H: int) -> F32Plan:
    """The f32 route's tiles for batch ``B`` and hidden size ``H``.

    The row tile is 8 rows up to B = 32, 16 up to 64 and 32 beyond: small
    tiles keep a thread's rows real and the grid wide.  ``n`` is the most
    units that leave ``F32_TARGET_BLOCKS`` blocks (more units a block read
    each h tile for more columns), then halves while the block's shared
    memory (all of K: the h tile and the four strips) does not fit; the
    row tile halves after it.  At H = 128, B = 16: 64 blocks of 4 units ×
    8 rows; at H = 512: n = 8 up to B = 8, 16 beyond.  Raises when
    ``H % 4 != 0`` (every TMA box must start on 16 bytes) or when no tile
    fits a block."""
    if B < 1 or H < 1:
        raise ValueError(f"f32_plan needs B, H >= 1, got B={B} H={H}")
    if H % 4:
        raise ValueError(f"the f32 route needs H % 4 == 0 for its TMA "
                         f"boxes, got H={H}")
    rows = 8 if B <= 32 else 16 if B <= 64 else 32
    tiles = -(-B // rows)
    n = next((u for u in F32_UNITS[::-1]
              if -(-H // u) * tiles >= F32_TARGET_BLOCKS), F32_UNITS[0])
    while n > F32_UNITS[0] and _f32_smem_bytes(n, rows, H) > MAX_SMEM:
        n //= 2
    while rows > F32_ROW_TILES[0] and _f32_smem_bytes(n, rows, H) > MAX_SMEM:
        rows //= 2
    return f32_plan_for(n, rows, B, H)


def f32_plan_for(n: int, rows: int, B: int, H: int) -> F32Plan:
    """The f32 plan at a given ``n`` and row tile: ``rr`` the most rows a
    thread takes (up to 4) that still leaves a warp's worth of threads,
    ``ks`` the K groups that fill the block up to ``F32_MAX_THREADS``
    threads (at most ``F32_MAX_GROUPS``, at most one a stage: each
    group's chain of stages is what a step waits on), a cluster of
    ``F32_CLUSTER`` where it divides the hidden tiles (else none), the
    grid that covers (B, H) once and the shared memory.  Raises when the
    tile is not one the kernel has or does not fit a block."""
    if n not in F32_UNITS or rows not in F32_ROW_TILES or H % 4:
        raise ValueError(f"no f32 tile at n={n} rows={rows} H={H}")
    smem = _f32_smem_bytes(n, rows, H)
    if smem > MAX_SMEM:
        raise ValueError(f"hidden size {H} needs {smem} bytes of shared-"
                         f"memory per block at n={n}, rows={rows}, more "
                         f"than {MAX_SMEM}")
    rr = next((r for r in (4, 2) if n * rows // r >= 32), 1)
    while n * rows // rr > F32_MAX_THREADS:
        rr *= 2
    group = n * rows // rr
    ks = max(1, min(F32_MAX_GROUPS, -(-H // F32_STAGE_K),
                    F32_MAX_THREADS // group))
    grid_x = -(-H // n)
    cluster = F32_CLUSTER if grid_x % F32_CLUSTER == 0 else 1
    return F32Plan(n, rows, rr, ks, cluster, (grid_x, -(-B // rows)),
                   ks * group, smem)


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use and bound once."""
    global _lib
    if _lib is None:
        from r2d2_tpu_torch.ops._build import library

        _lib = _bind(library(KERNEL))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_infer_cudacore.argtypes = [p, p, i, p, p, p, i, i, i, p]
    lib.lstm_infer_cudacore.restype = i
    lib.lstm_infer_wgmma.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.lstm_infer_wgmma.restype = i
    lib.lstm_infer_wgmma_smem.argtypes = [i, i]
    lib.lstm_infer_wgmma_smem.restype = ctypes.c_longlong
    lib.lstm_infer_f32.argtypes = [p, p, p, p, p] + [i] * 10 + [p]
    lib.lstm_infer_f32.restype = i
    lib.lstm_infer_f32_smem.argtypes = [i, i, i]
    lib.lstm_infer_f32_smem.restype = ctypes.c_longlong
    lib.lstm_infer_max_hidden.argtypes = []
    lib.lstm_infer_max_hidden.restype = i
    lib.lstm_infer_error_string.argtypes = [i]
    lib.lstm_infer_error_string.restype = ctypes.c_char_p
    lib.max_hidden = lib.lstm_infer_max_hidden()
    return lib


def _check_tma(wh: torch.Tensor) -> None:
    """What TMA needs of ``wh``: a contiguous row-major (H, 4H) tensor at a
    16-byte aligned address with a row stride (8H bytes in bf16) that is a
    multiple of 16.  Checked before anything is built or launched."""
    if not wh.is_contiguous():
        raise ValueError("wh must be contiguous: TMA reads it as a row-major "
                         "2-D tensor")
    if wh.data_ptr() % 16:
        raise ValueError(f"wh must be 16-byte aligned for TMA, its address "
                         f"is {wh.data_ptr():#x}")
    stride = wh.shape[1] * wh.element_size()
    if stride % 16:
        raise ValueError(f"wh's row stride of {stride} bytes is not a "
                         "multiple of 16, which TMA needs (H must be even)")


def _on_one_card(xp, wh, h0, c0) -> None:
    dev = xp.device
    for name, t in (("xp", xp), ("wh", wh), ("h0", h0), ("c0", c0)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every input on one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h0.dtype != torch.float32 or c0.dtype != torch.float32:
        raise TypeError("h0 and c0 must be float32")


def _launch(counter: str, xp, wh, h0, c0, call) -> Unroll:
    """Allocate the outputs, run ``call(lib, hs, c, stream)`` (which
    launches the T steps), raise on a launch error, count the call under
    ``counter``."""
    T, B, H4 = xp.shape
    dev = xp.device
    lib = _library()
    hs = torch.empty((T, B, H4 // 4), dtype=torch.float32, device=dev)
    c = torch.empty((B, H4 // 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        c.copy_(c0)   # c_T is updated in place from c0
        err = call(lib, hs, c, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lstm_infer ({counter}) launch failed: "
                           + lib.lstm_infer_error_string(err).decode())
    KERNEL_LAUNCHES.count(counter)
    return hs, hs[-1], c


def _launch_wgmma(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                  c0: torch.Tensor, plan: LaunchPlan) -> Unroll:
    """The tensor-core kernel at ``plan`` for bf16 ``wh``, on inputs that
    passed :func:`_check` (``lstm_unroll_cuda`` passes
    :func:`launch_plan`'s tiles, ``chip_smoke.py``'s tile sweep others)."""
    _check_tma(wh)
    _on_one_card(xp, wh, h0, c0)
    T, B, H4 = xp.shape
    _note_tensor_map(wh, plan.n)

    def call(lib, hs, c, stream):
        return lib.lstm_infer_wgmma(
            xp.data_ptr(), wh.data_ptr(), h0.data_ptr(), c.data_ptr(),
            hs.data_ptr(), T, B, H4 // 4, plan.n, plan.grid[0],
            plan.grid[1], stream)

    return _launch(KERNEL, xp, wh, h0, c0, call)


def _lstm_unroll_cudacore(xp: torch.Tensor, wh: torch.Tensor,
                          h0: torch.Tensor, c0: torch.Tensor,
                          plan: F32Plan = None) -> Unroll:
    """The f32 route: ``lstm_step_f32`` at ``plan`` (default
    :func:`f32_plan`'s tiles) for f32 ``wh``, on inputs that pass
    :func:`_check`, :func:`_check_tma` and H % 4 == 0.  Counts under
    ``CUDACORE_COUNTER``."""
    _check(xp, wh, h0, c0)
    if wh.dtype != torch.float32:
        raise TypeError(f"the f32 route takes f32 wh, got {wh.dtype}")
    _check_tma(wh)
    _on_one_card(xp, wh, h0, c0)
    T, B, H4 = xp.shape
    H = H4 // 4
    if plan is None:
        plan = f32_plan(B, H)

    def call(lib, hs, c, stream):
        return lib.lstm_infer_f32(
            xp.data_ptr(), wh.data_ptr(), h0.data_ptr(), c.data_ptr(),
            hs.data_ptr(), T, B, H, plan.n, plan.rows, plan.rr, plan.ks,
            plan.cluster, plan.grid[0], plan.grid[1], stream)

    return _launch(CUDACORE_COUNTER, xp, wh, h0, c0, call)


def _lstm_unroll_pr1(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor) -> Unroll:
    """The first CUDA-core design (``lstm_step_cudacore``) for f32 or bf16
    ``wh``.  No path of the port launches it: it is the comparison column
    of the card-side timings (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``).  Counts under ``PR1_COUNTER``."""
    _check(xp, wh, h0, c0)
    _on_one_card(xp, wh, h0, c0)
    T, B, H4 = xp.shape
    H = H4 // 4

    def call(lib, hs, c, stream):
        if H > lib.max_hidden:
            raise ValueError(f"hidden size {H} exceeds the CUDA-core "
                             f"kernel's shared-memory tile ({lib.max_hidden})")
        return lib.lstm_infer_cudacore(
            xp.data_ptr(), wh.data_ptr(), int(wh.dtype == torch.bfloat16),
            h0.data_ptr(), c.data_ptr(), hs.data_ptr(), T, B, H, stream)

    return _launch(PR1_COUNTER, xp, wh, h0, c0, call)


def lstm_unroll_cuda(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor) -> Unroll:
    """Launch the CUDA kernel of ``wh``'s dtype (the compute dtype): the
    f32 kernel for f32 (tensor cores have no exact f32 product: TF32 keeps
    10 bits), the tensor-core kernel for bf16.  All inputs must be
    contiguous on one CUDA device, and ``wh`` must suit TMA
    (:func:`_check_tma`; f32 also H % 4 == 0); anything else raises.
    Ticks the kernel's ``KERNEL_LAUNCHES`` counter (``KERNEL`` or
    ``CUDACORE_COUNTER``) once per call (one call runs T step launches)."""
    if wh.dtype == torch.float32:
        return _lstm_unroll_cudacore(xp, wh, h0, c0)
    _check(xp, wh, h0, c0)
    return _launch_wgmma(xp, wh, h0, c0,
                         launch_plan(xp.shape[1], xp.shape[2] // 4))


class _FusedInfer(torch.autograd.Function):
    """The inference unroll as an autograd node whose backward raises: a
    grad path must use the scan recurrence (``LSTMLayer`` impl "scan")."""

    @staticmethod
    def forward(ctx, xp, wh, h0, c0, compute_dtype):
        if xp.device.type == "cuda":
            hs, _, c = lstm_unroll_cuda(xp, wh, h0, c0)
        elif xp.device.type == "cpu":
            hs, _, c = lstm_unroll_reference(xp, wh, h0, c0, compute_dtype)
        else:
            raise ValueError(f"no lstm_infer path for device {xp.device}")
        return hs, c

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "the fused LSTM inference unroll is not differentiable; build "
            "the network with lstm_impl='scan' for any gradient path")


def lstm_unroll_infer(xp: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                      c0: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16) -> Unroll:
    """Fused inference unroll: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (module docstring)."""
    hs, c = _FusedInfer.apply(xp.float().contiguous(),
                              wh.to(compute_dtype).contiguous(),
                              h0.float().contiguous(),
                              c0.float().contiguous(), compute_dtype)
    return hs, hs[-1], c
