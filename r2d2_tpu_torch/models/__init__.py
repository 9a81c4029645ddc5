from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import (
    DuelingHead,
    LSTMLayer,
    MlpTorso,
    NatureTorso,
    R2D2Network,
    create_network,
    resolve_lstm_impl,
    zero_hidden,
)

__all__ = [
    "DuelingHead",
    "LSTMLayer",
    "MlpTorso",
    "NatureTorso",
    "R2D2Network",
    "create_network",
    "params_from_flax",
    "resolve_lstm_impl",
    "zero_hidden",
]
