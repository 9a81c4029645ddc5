"""Population training plane and standing evaluation service (port of
``r2d2_tpu/league``).

- :mod:`~r2d2_tpu_torch.league.population` — ``cfg.population_spec``
  resolved into per-fleet member configurations (env, epsilon ladder,
  discount, eval knobs), one fleet subprocess per member, member-tagged
  blocks flowing into the shared replay plane.
- :mod:`~r2d2_tpu_torch.league.scenarios` — each member's held-out
  evaluation suite: seeded env variants plus a lane of a batched device
  env through the ``envs/anakin.py`` four-method surface.
- :mod:`~r2d2_tpu_torch.league.eval_service` — :class:`EvalSidecar`, a
  supervised CPU subprocess that follows the run's checkpoints, scores
  every member on each, and publishes ``league.jsonl`` rows, the
  ``/statusz`` league table and ``league.*`` metrics.  Its death degrades
  ``/healthz``; training never stops for evaluation.

Importing this package imports neither ``train`` nor anything that opens
a CUDA context.
"""
from r2d2_tpu_torch.league.eval_service import EvalSidecar, league_table
from r2d2_tpu_torch.league.population import (
    Member,
    build_members,
    population_epsilons,
)

__all__ = [
    "EvalSidecar",
    "Member",
    "build_members",
    "league_table",
    "population_epsilons",
]
