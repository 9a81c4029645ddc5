"""The port's sharding table and learner mesh (parallel/sharding.py,
parallel/mesh.py), against the JAX package's.

Mirrors tests/test_sharding.py and tests/test_parallel.py's resolver and
mesh contracts: token and path normalisation, the override grammar,
longest pattern wins, scalars replicate, an unresolved leaf raises, the
divisibility guard, an entry longer than the shape raises, overrides,
moments inheriting their param's layout, every torso family resolving, the
batch/ring/PER keys, and the mesh always carrying three axes.  The tables
resolve from axis sizes alone; the mesh tests run in a world of one gloo
rank on an in-process store.

The cross-table test maps each port leaf through models/convert.py's name
and layout map to its flax leaf and requires the same logical dims sharded
over the same axes as JAX's ``ShardingTable`` resolves.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from r2d2_tpu.config import test_config as jax_test_config
from r2d2_tpu.models.network import create_network as jax_create_network
from r2d2_tpu.models.network import init_params
from r2d2_tpu.parallel import sharding as jsharding
from r2d2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from r2d2_tpu_torch import config as tconfig
from r2d2_tpu_torch.config import test_config as port_test_config
from r2d2_tpu_torch.learner.step import create_train_state
from r2d2_tpu_torch.models.convert import params_from_flax
from r2d2_tpu_torch.models.network import create_network
from r2d2_tpu_torch.parallel import sharding as psharding
from r2d2_tpu_torch.parallel.distributed import init_distributed
from r2d2_tpu_torch.parallel.mesh import (
    AXES,
    axis_sizes,
    make_mesh,
    mesh_sizes,
    trivial_mesh,
)
from r2d2_tpu_torch.parallel.sharding import (
    DEVICE_BATCH_KEYS,
    ShardingTable,
    UnresolvedShardingError,
    leaf_tokens,
    mesh_train_step,
)

A = 4
TORSOS = (("nature", dict(obs_shape=(84, 84, 1))),
          ("impala", dict(obs_shape=(24, 24, 1), obs_space_to_depth=False)),
          ("mlp", {}))


def table_on(**sizes):
    return ShardingTable(sizes=sizes)


@pytest.fixture
def world_of_one():
    """A gloo world of one rank on an in-process store."""
    init_distributed(store=dist.HashStore(), world_size=1, rank=0,
                     device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_state(cfg):
    net = create_network(cfg, A, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return net, create_train_state(cfg, net.state_dict())


# ------------------------------------------------------- normalization

@pytest.mark.parametrize("token", ["3", "lstm_0", "lstm_12", "Conv_2",
                                   "torso", "conv1", "head_x"])
def test_normalize_token_equals_jax(token):
    assert tconfig.normalize_token(token) == jsharding.normalize_token(token)


def test_normalize_path():
    assert psharding.normalize_path(("lstm_layers", "0", "wi")) == (
        "lstm_layers", "*", "wi")
    assert leaf_tokens("opt_state", "mu", "torso.convs.3.weight") == (
        "opt_state", "mu", "torso", "convs", "3", "weight")


@pytest.mark.parametrize("spec", [
    "lstm_*.wh=,tp;head.*.kernel=", "lstm_0.wh=", "a.b=dp,fsdp,tp",
    " x = tp ; y=", "head.value.kernel="])
def test_parse_table_equals_jax(spec):
    assert tconfig.parse_table(spec) == jsharding.parse_table(spec)


@pytest.mark.parametrize("bad", ["nopattern", "=tp", "a=mp", "a=dp,zz"])
def test_parse_table_rejects_malformed(bad):
    with pytest.raises(ValueError):
        tconfig.parse_table(bad)
    with pytest.raises(ValueError):
        jsharding.parse_table(bad)


def test_config_validates_sharding_table_and_axes():
    with pytest.raises(ValueError, match="axis"):
        port_test_config(sharding_table="a=mp")
    with pytest.raises(ValueError, match="mp"):
        port_test_config(mesh_shape=(("mp", 2),))
    with pytest.raises(ValueError, match="duplicate"):
        port_test_config(mesh_shape=(("dp", 2), ("dp", 2)))


# ------------------------------------------------------------- resolve

def test_lookup_longest_pattern_wins():
    table = ShardingTable(rules={"lstm_layers.*.wh": (None, "tp")})
    assert table.lookup(("params", "lstm_layers", "0", "wh")) == (None, "tp")
    assert table.lookup(("params", "lstm_layers", "3", "wi")) == (
        "fsdp", "tp")
    # the torso's dense and conv leaves resolve through their own entries
    assert table.lookup(("params", "torso", "dense", "weight")) == (
        "tp", "fsdp")
    assert table.lookup(("params", "torso", "convs", "7", "weight")) == (
        "fsdp",)


def test_scalars_replicate_without_a_table_entry():
    table = table_on(dp=2)
    assert table.spec(("opt_state", "count"), shape=()) == ()
    assert table.spec(("brand_new", "w"), shape=()) == ()


def test_unresolved_leaf_raises():
    with pytest.raises(UnresolvedShardingError, match="extend the table"):
        table_on().spec(("params", "brand_new_family", "w"), shape=(8, 8))


def test_divisibility_guard_falls_back_to_replication():
    table = table_on(dp=2, tp=2, fsdp=2)
    assert table.spec(("params", "lstm_layers", "0", "wi"),
                      shape=(16, 64)) == ("fsdp", "tp")
    # an odd output dim (the value head's 1) replicates
    assert table.spec(("params", "head", "val_out", "weight"),
                      shape=(1, 16)) == (None, "fsdp")
    assert table.spec(("params", "head", "adv_out", "bias"),
                      shape=(5,)) == (None,)
    assert table.placements((None, "fsdp")) == (
        Replicate(), Shard(1), Replicate())


def test_entry_longer_than_shape_raises():
    with pytest.raises(ValueError, match="more dims"):
        table_on().spec(("params", "lstm_layers", "0", "wi"), shape=(64,))


def test_two_dims_on_one_axis_raise():
    with pytest.raises(ValueError, match="two dims"):
        ShardingTable.placements(("tp", "tp"))


def test_cfg_override_extends_default_table():
    cfg = port_test_config(
        sharding_table="lstm_layers.*.wh=;head.*.weight=")
    table = ShardingTable(cfg=cfg, sizes=dict(dp=2, tp=2))
    assert table.spec(("params", "lstm_layers", "0", "wh"),
                      shape=(16, 64)) == (None, None)
    assert table.spec(("params", "head", "adv_hidden", "weight"),
                      shape=(16, 16)) == (None, None)
    assert table.spec(("params", "lstm_layers", "0", "wi"),
                      shape=(16, 64)) == ("fsdp", "tp")


def test_cfg_override_fully_specified_beats_wildcard_default():
    cfg = port_test_config(sharding_table="head.val_hidden.weight=")
    table = ShardingTable(cfg=cfg, sizes=dict(dp=2, tp=2))
    assert table.spec(("params", "head", "val_hidden", "weight"),
                      shape=(16, 16)) == (None, None)
    assert table.spec(("params", "head", "adv_hidden", "weight"),
                      shape=(16, 16)) == ("tp", "fsdp")


def test_cfg_override_with_concrete_layer_index_normalizes():
    cfg = port_test_config(sharding_table="lstm_layers.0.wh=")
    table = ShardingTable(cfg=cfg, sizes=dict(dp=2, tp=2))
    assert table.spec(("params", "lstm_layers", "1", "wh"),
                      shape=(16, 64)) == (None, None)


def test_table_rejects_rules_as_cfg():
    with pytest.raises(TypeError, match="rules="):
        ShardingTable(None, {"a.b": ("dp",)})


def test_state_shardings_moments_inherit_param_layout():
    cfg = port_test_config()
    _, state = port_state(cfg)
    sh = ShardingTable(sizes=dict(dp=4, tp=2)).state_shardings(state)
    name = "lstm_layers.0.wi"
    p, t = sh.params[name], sh.target_params[name]
    mu, nu = sh.opt_state.mu[name], sh.opt_state.nu[name]
    assert p == t == mu == nu == (Replicate(), Shard(0), Shard(1))
    assert sh.step == sh.opt_state.count == (Replicate(),) * 3


def test_state_shardings_unresolved_leaf_fails_fast():
    cfg = port_test_config()
    _, state = port_state(cfg)
    state.params["new_block.0.w"] = torch.zeros(8, 8)
    with pytest.raises(UnresolvedShardingError):
        ShardingTable().state_shardings(state)


@pytest.mark.parametrize("torso,kw", TORSOS, ids=[t for t, _ in TORSOS])
def test_every_torso_family_resolves(torso, kw):
    cfg = port_test_config(torso=torso, **kw)
    _, state = port_state(cfg)
    sh = ShardingTable(sizes=dict(dp=2, fsdp=2, tp=2)).state_shardings(state)
    # the big kernels genuinely shard over fsdp and tp
    flat = [pl for pl in sh.params.values()]
    assert any(isinstance(pl[1], Shard) for pl in flat)
    assert any(isinstance(pl[2], Shard) for pl in flat)


def _flax_leaf(port_name: str, flax_torso) -> tuple:
    """The flax path of a port parameter and how the port's dims map onto
    the flax leaf's (``perm[i]``: the flax dim of port dim i) — the
    inverse of models/convert.py's map."""
    from r2d2_tpu_torch.models import convert

    parts = port_name.split(".")
    if parts[0] == "lstm_layers":
        return ("params", f"lstm_{parts[1]}", parts[2]), (0, 1)
    if parts[0] == "head":
        leaf = "kernel" if parts[2] == "weight" else "bias"
        return ("params", "head", parts[1], leaf), (
            (1, 0) if leaf == "kernel" else (0,))
    names = {v: k for k, v in convert._torso_names(flax_torso).items()}
    layer = names[".".join(parts[1:-1])]
    if parts[-1] == "bias":
        return ("params", "torso", layer, "bias"), (0,)
    if layer.startswith("Dense"):
        return ("params", "torso", layer, "kernel"), (1, 0)
    # OIHW ← HWIO
    return ("params", "torso", layer, "kernel"), (3, 2, 0, 1)


@pytest.mark.parametrize("torso,kw", TORSOS, ids=[t for t, _ in TORSOS])
def test_port_table_shards_the_same_logical_dims_as_jax(torso, kw):
    """dp = 2, fsdp = 2, tp = 2: every port leaf shards the same flax dims
    over the same axes as JAX's table resolves for its flax leaf."""
    jcfg = jax_test_config(torso=torso, **kw)
    jnet = jax_create_network(jcfg, A)
    flax = init_params(jcfg, jnet, jax.random.PRNGKey(0))
    jtable = jsharding.ShardingTable(jax_make_mesh(jcfg.replace(
        mesh_shape=(("dp", 2), ("fsdp", 2), ("tp", 2)))), jcfg)
    port = params_from_flax(jax.device_get(flax))
    table = ShardingTable(sizes=dict(dp=2, fsdp=2, tp=2))
    flat = {tuple(str(jsharding._path_token(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(flax)[0]}
    assert len(flat) == len(port)
    for name, t in port.items():
        fpath, perm = _flax_leaf(name, flax["params"]["torso"])
        fleaf = flat[fpath]
        assert tuple(np.shape(fleaf)[perm[i]] for i in range(t.ndim)) == (
            tuple(t.shape)), name
        jspec = tuple(jtable.spec(fpath, tuple(np.shape(fleaf))))
        jspec = jspec + (None,) * (np.ndim(fleaf) - len(jspec))
        pspec = table.spec(leaf_tokens("params", name), tuple(t.shape))
        assert tuple(jspec[perm[i]] for i in range(t.ndim)) == pspec, (
            name, fpath, jspec, pspec)


def test_batch_shardings_cover_device_batch_keys():
    sh = table_on(dp=2).batch_shardings()
    assert set(sh) == set(DEVICE_BATCH_KEYS)
    assert all(pl == (Shard(0), Replicate(), Replicate())
               for pl in sh.values())


def test_ring_and_per_shardings_layouts():
    table = table_on(dp=2)
    assert all(pl == (Replicate(),) * 3
               for pl in table.ring_shardings("replicated").values())
    assert all(pl[0] == Shard(0)
               for pl in table.ring_shardings("dp").values())
    with pytest.raises(ValueError, match="layout"):
        table.ring_shardings("diagonal")
    per = table.per_shardings("dp")
    assert set(per) == {"prios", "seq_meta", "first"}
    assert all(pl[0] == Shard(0) for pl in per.values())


# ---------------------------------------------------------------- mesh

def test_mesh_sizes_default_spans_the_world_and_errors():
    assert mesh_sizes(port_test_config(), 8) == dict(dp=8, fsdp=1, tp=1)
    cfg = port_test_config(mesh_shape=(("dp", 2), ("tp", 2)))
    assert mesh_sizes(cfg, 4) == dict(dp=2, fsdp=1, tp=2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_sizes(cfg, 2)
    with pytest.raises(ValueError, match="every rank"):
        mesh_sizes(cfg, 8)


def test_mesh_always_carries_all_three_axes(world_of_one):
    for spec in ((), (("dp", 1),), (("tp", 1),)):
        mesh = make_mesh(port_test_config(mesh_shape=spec), "cpu")
        assert tuple(mesh.mesh_dim_names) == AXES
        assert axis_sizes(mesh) == dict(dp=1, fsdp=1, tp=1)
    assert tuple(trivial_mesh("cpu").mesh_dim_names) == AXES
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(port_test_config(mesh_shape=(("dp", 2),)), "cpu")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(port_test_config(), "cpu")


def test_place_state_puts_every_leaf_on_the_mesh(world_of_one):
    cfg = port_test_config()
    _, state = port_state(cfg)
    ref = {k: v.clone() for k, v in state.params.items()}
    table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
    placed = table.place_state(state)
    for d in (placed.params, placed.target_params, placed.opt_state.mu,
              placed.opt_state.nu):
        assert all(isinstance(v, DTensor) for v in d.values())
    assert all(torch.equal(placed.params[k].full_tensor(), ref[k])
               for k in ref)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        ShardingTable(sizes=dict(dp=1)).place_state(state)


def test_mesh_train_step_requires_state_template_and_divisible_batch(
        world_of_one):
    cfg = port_test_config()
    net, state = port_state(cfg)
    table = ShardingTable(make_mesh(cfg, "cpu"), cfg)
    with pytest.raises(ValueError, match="state_template"):
        mesh_train_step(cfg, net, table)
    odd = ShardingTable(sizes=dict(dp=3))
    with pytest.raises(ValueError, match="divisible"):
        psharding._check_batch(cfg, odd)


def test_fleet_and_shard_modules_leave_the_distributed_stack_unloaded():
    """The parallel package exports the mesh modules lazily: a fleet
    child's imports (and the network it acts through) never load
    DTensor, and a replay shard child's never load torch."""
    import subprocess
    import sys

    code = ("import sys, r2d2_tpu_torch.parallel.replay_shards; "
            "assert 'torch' not in sys.modules, 'shard'; "
            "import r2d2_tpu_torch.parallel.actor_procs, "
            "r2d2_tpu_torch.models.network, r2d2_tpu_torch.parallel as p; "
            "assert 'torch.distributed.tensor' not in sys.modules, 'fleet'; "
            "p.ShardingTable; "
            "assert 'torch.distributed.tensor' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
