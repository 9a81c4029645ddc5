"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version."""
from r2d2_tpu_torch.ops.lstm import (
    lstm_unroll_cuda,
    lstm_unroll_infer,
    lstm_unroll_reference,
)

__all__ = ["lstm_unroll_cuda", "lstm_unroll_infer", "lstm_unroll_reference"]
