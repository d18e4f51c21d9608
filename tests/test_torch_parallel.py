"""The port's parallel/ modules in one process, against the JAX package's
armnet_tpu/parallel/ (the 8-device virtual CPU mesh of tests/conftest.py):

  * parse_mesh_spec's cases and errors, and make_mesh's axis sizes and
    row-major rank coordinates against the JAX mesh's device layout;
  * required_capacity_factor equal to the JAX function on the same ids;
  * the sharding rule picks the tables the JAX leaf rule shards, for every
    zoo model; a model axis that does not divide nfeat warns;
  * maybe_initialize_distributed is a no-op without torchrun's environment
    and raises on a half-set one;
  * the sharded lookups of a one-process mesh are the replicated lookup.

The lookups across processes are in tests/test_torch_multiprocess.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.models import create_model as jax_create_model
from armnet_tpu.models.config import ModelConfig as JaxModelConfig
from armnet_tpu.parallel.embedding_parallel import (
    required_capacity_factor as jax_required_capacity_factor)
from armnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from armnet_tpu.parallel.mesh import parse_mesh_spec as jax_parse_mesh_spec
from armnet_tpu.parallel.sharding import _leaf_name, leaf_spec
from armnet_tpu_torch.bridge import _port_key
from armnet_tpu_torch.models import MODEL_NAMES, create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.embedding import embedding_bag
from armnet_tpu_torch.parallel import mesh as mesh_mod
from armnet_tpu_torch.parallel.embedding_parallel import (
    a2a_overflow_count, required_capacity_factor, sharded_embedding_bag,
    sharded_embedding_bag_a2a)
from armnet_tpu_torch.parallel.mesh import (make_mesh,
                                            maybe_initialize_distributed,
                                            parse_mesh_spec)
from armnet_tpu_torch.parallel.sharding import shard_tables, table_modules
from armnet_tpu_torch.utils.config import ExperimentConfig, check_supported

SPECS = ["", "data:4,model:2", "data:-1,model:2", "model:2,data:4",
         "data:2,model:4", "model:8", "data:8", "model:-1"]


@pytest.mark.parametrize("spec", SPECS + ["data:2", "model:3,data:1"])
def test_parse_mesh_spec_matches_jax(spec):
    assert parse_mesh_spec(spec) == jax_parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["data:2,data:4", "data:0,model:-1",
                                  "data:-2", ":2", "data:x"])
def test_parse_mesh_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as jax_err:
        jax_parse_mesh_spec(spec)
    with pytest.raises(ValueError) as err:
        parse_mesh_spec(spec)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("spec", SPECS)
def test_make_mesh_places_ranks_as_the_jax_mesh(spec):
    """Rank r sits where the JAX mesh puts device r: row-major over the
    spec's axes."""
    jmesh = jax_make_mesh(spec)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        m = make_mesh(spec, world_size=8, rank=rank)
        assert m.shape == dict(jmesh.shape)
        where = dict(zip(jmesh.axis_names,
                         (int(i[0]) for i in np.nonzero(ids == rank))))
        assert (m.data_index, m.model_index) == (where.get("data", 0),
                                                 where.get("model", 0))
        assert m.data_group is None and not m.distributed


@pytest.mark.parametrize("spec,world", [("data:3,model:2", 8),
                                        ("data:-1,model:-1", 8),
                                        ("data:-1,model:3", 8),
                                        ("pipe:2", 2)])
def test_make_mesh_errors(spec, world):
    with pytest.raises(ValueError):
        make_mesh(spec, world_size=world, rank=0)


def test_one_process_mesh():
    m = make_mesh("data:1,model:1")
    assert (m.world_size, m.rank, m.data_size, m.model_size) == (1, 0, 1, 1)
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        make_mesh("model:2")


@pytest.mark.parametrize("margin", [1.0, 1.25])
@pytest.mark.parametrize("spec", ["data:2,model:4", "data:4,model:2",
                                  "data:1,model:8"])
def test_required_capacity_factor_matches_jax(spec, margin):
    rng = np.random.RandomState(7)
    nfeat = 64
    skewed = np.zeros((8, 10), np.int32)              # every id -> owner 0
    zipf = np.minimum(rng.zipf(1.3, (64, 10)) - 1, nfeat - 1).astype(
        np.int32)
    uniform = rng.randint(0, nfeat, (64, 10)).astype(np.int32)
    ragged = rng.randint(0, nfeat, (24, 7)).astype(np.int32)
    batches = [skewed, zipf, uniform, ragged]
    got = required_capacity_factor(batches, nfeat,
                                   make_mesh(spec, world_size=8, rank=0),
                                   margin=margin)
    want = jax_required_capacity_factor(batches, nfeat, jax_make_mesh(spec),
                                        margin=margin)
    assert got == want
    assert required_capacity_factor([uniform[:4, :2]], nfeat,
                                    make_mesh(spec, world_size=8, rank=0)) \
        == 1.0                                        # under the floor


def _jax_sharded_names(kw):
    """Port names of the leaves that the JAX leaf rule row-shards."""
    jm = jax_create_model(JaxModelConfig(**kw))
    batch = {"id": jnp.zeros((4, kw["nfield"]), jnp.int32),
             "value": jnp.ones((4, kw["nfield"]), jnp.float32)}
    params = jm.init(jax.random.PRNGKey(0), batch)["params"]
    mesh = jax_make_mesh("data:4,model:2")
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if leaf_spec(leaf, kw["nfeat"], mesh, True,
                     name=_leaf_name(path)) != jax.sharding.PartitionSpec():
            keys = "/".join(p.key for p in path)
            names.add(_port_key(f"params/{keys}")[0])
    return names


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_sharding_rule_picks_the_jax_tables(name):
    kw = dict(model=name, nfeat=96, nfield=5, nemb=6, h=7, k=3,
              mlp_nlayer=1, mlp_nhid=11, nattn_head=2, alpha=1.7,
              ensemble=name in ("armnet", "armnet_1h", "gc_arm", "sa_glu",
                                "afn"),
              dnn_nlayer=1, dnn_nhid=9)
    model = create_model(ModelConfig(**kw))
    got = {n for n, _ in table_modules(model, kw["nfeat"])}
    assert got == _jax_sharded_names(kw)
    assert got                                  # every model has a table


def test_shard_tables_keeps_the_row_block_of_the_init():
    kw = dict(model="dfm", nfeat=96, nfield=5, nemb=6, mlp_nlayer=1,
              mlp_nhid=11)
    full = create_model(ModelConfig(**kw), seed=3)
    for rank in range(4):
        mesh = make_mesh("data:2,model:2", world_size=4, rank=rank)
        model = create_model(ModelConfig(**kw), seed=3)
        names = shard_tables(model, mesh, 96, "a2a", 2.0)
        assert names == ["embedding.weight", "linear.weight"]
        params = dict(model.named_parameters())
        ref = dict(full.named_parameters())
        m = mesh.model_index
        for n in names:
            assert params[n].shape[0] == 48
            torch.testing.assert_close(params[n], ref[n][48 * m:48 * m + 48])
    model = create_model(ModelConfig(**kw), seed=3)
    with pytest.warns(UserWarning, match="do not divide the model axis"):
        assert shard_tables(model, make_mesh("model:5", world_size=5, rank=0),
                            96) == []
    assert model.embedding.weight.shape[0] == 96


@pytest.mark.parametrize("lookup", ["psum", "a2a"])
def test_one_process_sharded_lookup_is_the_replicated_one(lookup):
    """A one-process mesh (no process group): both exchanges give the
    replicated lookup and its gradients, wrapped and out-of-range ids
    included, and the overflow count is 0 at the default capacity."""
    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-40, 40, (9, 4)))
    ids[0, 0], ids[1, 1] = 40, -41
    values = torch.from_numpy(rng.rand(9, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(9, 4, 6).astype(np.float32))
    mesh = make_mesh("data:1,model:1")
    fn = (sharded_embedding_bag if lookup == "psum"
          else sharded_embedding_bag_a2a)
    t1, v1 = table.clone().requires_grad_(), values.clone().requires_grad_()
    t2, v2 = table.clone().requires_grad_(), values.clone().requires_grad_()
    got = fn(t1, ids, v1, mesh)
    want = embedding_bag(t2, ids, v2)
    torch.testing.assert_close(got, want, equal_nan=True)
    (torch.nan_to_num(got) * w).sum().backward()
    (torch.nan_to_num(want) * w).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad)
    ok = ~torch.isnan(want).any(-1)
    torch.testing.assert_close(v1.grad[ok], v2.grad[ok])
    assert float(a2a_overflow_count(ids, 40, mesh)) == 0.0


def test_maybe_initialize_distributed_reads_torchruns_environment(
        monkeypatch):
    for k in mesh_mod._ENV:
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_config_checks_the_multi_process_flags():
    check_supported(ExperimentConfig(mesh="data:-1,model:2",
                                     shard_embedding=True,
                                     embedding_exchange="a2a"))
    with pytest.raises(ValueError, match="duplicate axis"):
        check_supported(ExperimentConfig(mesh="data:2,data:2"))
    with pytest.raises(ValueError, match="embedding_exchange"):
        check_supported(ExperimentConfig(embedding_exchange="ring"))
