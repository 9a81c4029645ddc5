"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), at its full power limit of 700 W.  A card set below
that limit runs slower under load: every result carries the card's name
and power limit beside the shares taken against these peaks."""
from __future__ import annotations

import subprocess
from typing import Dict, Optional

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
              "tf32": 495e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12


def card() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` reads them (None
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return dict(name=None, power_limit=None)
    if not out:
        return dict(name=None, power_limit=None)
    name, _, limit = out[0].rpartition(",")
    return dict(name=name.strip(), power_limit=limit.strip())
