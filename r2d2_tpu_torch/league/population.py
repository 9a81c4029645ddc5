"""Population plane: per-fleet member configurations.

Port of ``r2d2_tpu/league/population.py``.  ``cfg.population_spec``
(grammar and validation in ``config.parse_population``) declares N
members; this module resolves them into what the fabric consumes:

- :class:`Member` — ``(member_id, name, preset, cfg, overrides)``, where
  ``cfg`` is the BASE config with the member's whitelisted overrides
  applied (``config.POPULATION_MEMBER_FIELDS``: the env, the epsilon
  ladder, the discount and eval knobs; anything that would change the
  param shapes, the block wire format or the fabric topology is refused at
  Config construction);
- :func:`build_members` — the spec → ``[Member]`` resolution;
- :func:`assert_wire_compatible` — every member's block slot layout must
  be byte-identical to the base's (the whitelist guarantees it; this
  asserts it, since a torn channel would fail silently);
- :func:`population_epsilons` — the global lane-aligned epsilon list:
  member f owns fleet f's contiguous lane shard (``actor.fleet_shards``),
  and its lanes run the member's OWN ladder.

Members map 1:1 onto process fleets in declaration order (Config
validation pins ``actor_fleets == len(members)``), so the fleet machinery
(shm block channels, the stats slab, watchdog respawns, chaos kills)
carries the population; the only member state on the wire is the block's
``member_id`` word (``replay/block.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from r2d2_tpu_torch.config import Config, parse_population


@dataclasses.dataclass(frozen=True)
class Member:
    """One population member, resolved against the base config."""

    member_id: int
    name: str
    preset: str
    cfg: Config                      # base.replace(**overrides)
    overrides: Dict[str, Any]        # the applied override dict


def build_members(cfg: Config) -> List[Member]:
    """Resolve ``cfg.population_spec`` into :class:`Member` objects.

    An empty spec gives the single base-config member (the degenerate
    population, so callers need no branch).  Raises ``ValueError`` where
    Config construction would."""
    if not cfg.population_spec:
        return [Member(0, "base", "default", cfg, {})]
    out = []
    for i, m in enumerate(parse_population(cfg.population_spec)):
        mcfg = cfg.replace(population_spec="", **m["overrides"])
        out.append(Member(i, m["name"], m["preset"], mcfg,
                          dict(m["overrides"])))
    return out


def assert_wire_compatible(cfg: Config, members: List[Member],
                           action_dim: int) -> None:
    """Every member's block slot layout must equal the base's: a fleet
    serialises under its member's config while the trainer's channel was
    laid out under the base, and a divergence would tear the transport
    without an error."""
    from r2d2_tpu_torch.replay.block import block_slot_spec, slot_layout

    base = slot_layout(block_slot_spec(cfg, action_dim))
    for m in members:
        got = slot_layout(block_slot_spec(m.cfg, action_dim))
        if got != base:
            raise ValueError(
                f"population member {m.member_id} ({m.name}) changes the "
                "block wire layout — overrides "
                f"{sorted(m.overrides)} must not touch replay geometry "
                "(this should have been caught by "
                "POPULATION_MEMBER_FIELDS; report it)")


def population_epsilons(cfg: Config, members: List[Member]) -> List[float]:
    """The global lane-aligned epsilon list of a population run: fleet f's
    contiguous lane shard carries member f's own ladder.  A single-member
    population reproduces the global ladder exactly."""
    from r2d2_tpu_torch.actor import fleet_shards
    from r2d2_tpu_torch.utils.math import epsilon_ladder

    shards, _ = fleet_shards(cfg)
    if len(shards) != len(members):
        raise ValueError(
            f"{len(shards)} fleet shards for {len(members)} members — "
            "Config validation should have pinned actor_fleets to the "
            "member count")
    out: List[float] = []
    for m, (lo, hi) in zip(members, shards):
        lanes = hi - lo
        out.extend(
            epsilon_ladder(i, lanes, m.cfg.base_eps, m.cfg.eps_alpha)
            for i in range(lanes))
    return out
