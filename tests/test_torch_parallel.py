"""The port's mesh and sharding layouts against the JAX package's, with
no process group.

``MeshSpec``, ``for_devices``, the rules tables and their specs equal
JAX's over a table of cases (errors included). For every leaf of the
test-tiny Llama on three meshes, the shard the port keeps at a mesh
coordinate (``local_shard``, and the model's own ``params_from_numpy``
on a ``Mesh`` built for that rank) is exactly the shard that JAX's
``param_shardings`` puts on the device at that coordinate, read through
``addressable_shards`` on XLA's 8 virtual CPU devices.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import sharding as jax_sharding
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.parallel import mesh as torch_mesh
from skypilot_tpu_torch.parallel import sharding as torch_sharding
from skypilot_tpu_torch.train import run as torch_run

SPEC_CASES = [{}, {'dp': 2}, {'fsdp': 4, 'tp': 2},
              {'dcn': 2, 'dp': 2, 'fsdp': 2}, {'pp': 2, 'sp': 2, 'ep': 2},
              {'tp': 8}, {'dcn': 4, 'tp': 2}]


@pytest.mark.parametrize('sizes', SPEC_CASES, ids=str)
def test_mesh_spec_matches_jax(sizes):
    want = jax_mesh.MeshSpec(**sizes)
    got = torch_mesh.MeshSpec(**sizes)
    assert got.sizes == want.sizes
    assert list(got.sizes) == list(jax_mesh.MESH_AXES)
    assert got.num_devices == want.num_devices
    assert torch_mesh.MESH_AXIS_DIVISORS == jax_mesh.MESH_AXIS_DIVISORS


FOR_DEVICES_CASES = [
    (8, {}), (8, {'tp': 2}), (8, {'tp': 2, 'fsdp': 2}),
    (16, {'dcn': 2, 'tp': 2}), (8, {'tp': 3}), (8, {'tp': 2, 'fsdp': 3}),
    (12, {'sp': 2, 'pp': 3}), (4, {'ep': 2, 'fsdp': 1})]


@pytest.mark.parametrize('n,kwargs', FOR_DEVICES_CASES, ids=str)
def test_for_devices_matches_jax(n, kwargs):
    def outcome(cls):
        try:
            return cls.for_devices(n, **kwargs).sizes
        except ValueError as e:
            return str(e)
    assert outcome(torch_mesh.MeshSpec) == outcome(jax_mesh.MeshSpec)


@pytest.mark.parametrize('axis', jax_mesh.MESH_AXES)
def test_mesh_spec_validation_matches_jax(axis):
    with pytest.raises(ValueError) as want:
        jax_mesh.MeshSpec(**{axis: 0})
    with pytest.raises(ValueError) as got:
        torch_mesh.MeshSpec(**{axis: 0})
    assert str(got.value) == str(want.value)


LOGICAL = [('batch', 'seq'), ('vocab', 'embed'), ('embed', 'vocab'),
           ('layers', 'embed', 'heads', None), ('layers', 'mlp', 'embed'),
           ('batch', 'seq', 'act_heads', None), (None,), ('expert', 'qkv'),
           ('batch', 'seq', 'act_vocab'), ('act_embed', 'act_mlp', 'nope')]


@pytest.mark.parametrize('logical', LOGICAL, ids=str)
def test_rules_spec_matches_jax(logical):
    for jr, tr in ((jax_sharding.DEFAULT_RULES, torch_sharding.DEFAULT_RULES),
                   (jax_sharding.multislice_rules(),
                    torch_sharding.multislice_rules()),
                   (jax_sharding.DEFAULT_RULES.with_overrides(embed=None),
                    torch_sharding.DEFAULT_RULES.with_overrides(embed=None))):
        assert tr.spec(*logical) == tuple(jr.spec(*logical))
    assert torch_sharding.multislice_rules().rules == \
        jax_sharding.multislice_rules().rules


def test_mesh_coordinates_are_row_major_and_groups_follow_axes():
    spec = torch_mesh.MeshSpec(dcn=2, dp=2, fsdp=2, tp=2)
    mesh = torch_mesh.Mesh(spec, rank=13)  # 0b1101: dcn 1, dp 1, fsdp 0, tp 1
    assert mesh.coords == {'dcn': 1, 'pp': 0, 'dp': 1, 'fsdp': 0, 'ep': 0,
                           'sp': 0, 'tp': 1}
    assert [mesh.rank_of(mesh.coords_of(r)) for r in range(16)] == \
        list(range(16))
    assert mesh.ranks('tp') == [12, 13]
    assert mesh.ranks(('dp', 'fsdp')) == [9, 11, 13, 15]
    assert mesh.ranks(('dcn', 'dp', 'fsdp')) == [1, 3, 5, 7, 9, 11, 13, 15]
    assert mesh.index(('dp', 'fsdp')) == 2
    assert mesh.live(('dcn', 'pp', 'tp')) == ('dcn', 'tp')
    with pytest.raises(ValueError, match='order'):
        mesh.live(('fsdp', 'dp'))
    with pytest.raises(ValueError, match='outside'):
        torch_mesh.Mesh(spec, rank=16)


def test_make_mesh_without_a_group_is_one_device():
    assert torch_mesh.make_mesh(torch_mesh.MeshSpec(), 'cpu').num_devices == 1
    with pytest.raises(ValueError, match='MeshSpec wants 2 devices'):
        torch_mesh.make_mesh(torch_mesh.MeshSpec(fsdp=2), 'cpu')


# -- every leaf's shard at every coordinate -----------------------------------
MESHES = {'dp2_fsdp2_tp2': ({'dp': 2, 'fsdp': 2, 'tp': 2}, False),
          'fsdp2_tp2': ({'fsdp': 2, 'tp': 2}, False),
          'dcn2_fsdp2': ({'dcn': 2, 'fsdp': 2}, True)}
CFG = torch_llama.PRESETS['test-tiny']


@pytest.fixture(scope='module')
def jax_params():
    jm = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'])
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


@pytest.fixture(scope='module')
def placed(jax_params):
    """mesh name -> (the JAX mesh, the params placed by
    ``param_shardings``, the port's rules)."""
    out = {}
    for name, (sizes, multislice) in MESHES.items():
        spec = jax_mesh.MeshSpec(**sizes)
        mesh = jax_mesh.make_mesh(spec,
                                  devices=jax.devices()[:spec.num_devices])
        rules = (jax_sharding.multislice_rules() if multislice
                 else jax_sharding.DEFAULT_RULES)
        model = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'],
                                     mesh=mesh, rules=rules)
        params = jax.device_put(jax.tree.map(jnp.asarray, jax_params),
                                model.param_shardings())
        out[name] = (mesh, params,
                     torch_sharding.multislice_rules() if multislice
                     else torch_sharding.DEFAULT_RULES)
    return out


def _leaves(tree, prefix=''):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f'{prefix}{key}/')
        else:
            yield prefix + key, value


def _coords(jmesh, device):
    where = np.argwhere(jmesh.devices == device)[0]
    return dict(zip(jmesh.axis_names, (int(i) for i in where)))


LEAVES = ['embed', 'final_norm', 'lm_head'] + [
    f'layers/{n}' for n in ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up',
                            'w_down', 'attn_norm', 'mlp_norm')]


@pytest.mark.parametrize('mesh_name,leaf',
                         list(itertools.product(MESHES, LEAVES)))
def test_local_shard_is_jax_shard_at_each_coordinate(placed, jax_params,
                                                     mesh_name, leaf):
    jmesh, params, rules = placed[mesh_name]
    full = torch.from_numpy(np.array(dict(_leaves(jax_params))[leaf]))
    spec = torch_sharding.tree_specs(rules, torch_llama.logical_axes(CFG))
    for part in leaf.split('/'):
        spec = spec[part]
    tmesh_spec = torch_mesh.MeshSpec(**MESHES[mesh_name][0])
    shards = dict(_leaves(params))[leaf].addressable_shards
    assert len(shards) == tmesh_spec.num_devices
    for shard in shards:
        coords = _coords(jmesh, shard.device)
        tmesh = torch_mesh.Mesh(tmesh_spec,
                                torch_mesh.Mesh(tmesh_spec).rank_of(coords))
        got = torch_sharding.local_shard(full, spec, tmesh)
        want = np.asarray(shard.data)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('mesh_name', MESHES)
def test_model_keeps_the_jax_shard_of_every_leaf(placed, jax_params,
                                                 mesh_name):
    """``LlamaModel(mesh=...)`` allocates each leaf at its local shape and
    ``params_from_numpy`` keeps exactly JAX's shard; ``init`` on the mesh
    keeps the shard of the one-device init's draw."""
    jmesh, params, rules = placed[mesh_name]
    tspec = torch_mesh.MeshSpec(**MESHES[mesh_name][0])
    gen = torch.Generator()
    gen.manual_seed(0)
    one = dict(_leaves(torch_llama.LlamaModel(CFG, device='cpu').init(gen)))
    jleaves = dict(_leaves(params))
    for rank in range(tspec.num_devices):
        tmesh = torch_mesh.Mesh(tspec, rank)
        model = torch_llama.LlamaModel(CFG, device='cpu', mesh=tmesh,
                                       rules=rules)
        got = dict(_leaves(model.params_from_numpy(jax_params)))
        device = jmesh.devices[tuple(tmesh.coords[a]
                                     for a in jmesh.axis_names)]
        for leaf in LEAVES:
            shard = next(s for s in jleaves[leaf].addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(got[leaf].numpy(),
                                          np.asarray(shard.data))
        gen.manual_seed(0)
        drawn = dict(_leaves(model.init(gen)))
        for leaf in LEAVES:
            want = torch_sharding.local_shard(one[leaf],
                                              model.specs[leaf], tmesh)
            assert torch.equal(drawn[leaf], want), leaf


@pytest.mark.parametrize('embed', [('fsdp', 'tp'), 'tp'])
def test_embedding_refuses_embed_axes_outside_the_batch(embed):
    """Embed axes partly in the batch axes (JAX leaves it to GSPMD) or
    outside them (JAX gathers features): no rules table of the repo makes
    either layout, and the port raises instead of mis-permuting rows; so
    does the model."""
    from skypilot_tpu_torch.ops.embedding import embed_lookup
    mesh = torch_mesh.Mesh(torch_mesh.MeshSpec(fsdp=2, tp=2), rank=0)
    rules = torch_sharding.DEFAULT_RULES.with_overrides(embed=embed,
                                                        vocab=None)
    with pytest.raises(NotImplementedError, match='outside the batch'):
        embed_lookup(torch.zeros(8, 4), torch.zeros(2, 3, dtype=torch.long),
                     mesh, rules)
    with pytest.raises(NotImplementedError):
        torch_llama.LlamaModel(CFG, device='cpu', mesh=mesh, rules=rules)
    # No mesh, or an unsharded table: a plain gather.
    table = torch.arange(12.0).view(6, 2)
    tokens = torch.tensor([[5, 0, 2]])
    assert torch.equal(embed_lookup(table, tokens), table[tokens])
    assert torch.equal(embed_lookup(table, tokens, torch_mesh.Mesh(
        torch_mesh.MeshSpec(dp=2), 1), torch_sharding.DEFAULT_RULES),
        table[tokens])


def test_model_refuses_axes_not_ported():
    """ep is ported: a dense Llama is replicated over it (as GSPMD
    replicates it) and Mixtral splits its experts over it; Mixtral takes
    fsdp, sp and pp meshes too. sp with pp is refused as JAX refuses
    it."""
    from skypilot_tpu_torch.models import mixtral
    mesh = torch_mesh.Mesh(torch_mesh.MeshSpec(ep=2))
    model = torch_llama.LlamaModel(CFG, device='cpu', mesh=mesh)
    assert tuple(model.layers['wq'].shape) == (2, 64, 4, 16)
    assert tuple(model.layers['w_gate'].shape) == (2, 64, 128)
    assert all(a != 'ep' for spec in model.specs.values()
               for entry in spec for a in torch_mesh.as_axes(entry))
    mesh = torch_mesh.Mesh(torch_mesh.MeshSpec(sp=2, pp=2))
    with pytest.raises(NotImplementedError, match='pp > 1 with sp > 1'):
        torch_llama.LlamaModel(CFG, device='cpu', mesh=mesh)
    moe = mixtral.PRESETS['test-tiny-moe']
    for sizes, gate, router in (
            ({'ep': 2}, (2, 2, 64, 128), (2, 64, 4)),
            ({'fsdp': 2}, (2, 4, 32, 128), (2, 32, 4)),
            ({'sp': 2}, (2, 4, 64, 128), (2, 64, 4)),
            ({'pp': 2}, (1, 4, 64, 128), (1, 64, 4))):
        model = mixtral.MixtralModel(moe, device='cpu', mesh=torch_mesh.Mesh(
            torch_mesh.MeshSpec(**sizes)))
        assert tuple(model.layers['we_gate'].shape) == gate, sizes
        assert tuple(model.layers['router'].shape) == router, sizes


# -- Mixtral's leaves on ep meshes --------------------------------------------
MOE_MESHES = {'ep2_fsdp2': {'ep': 2, 'fsdp': 2}, 'ep2_tp2': {'ep': 2, 'tp': 2}}
MOE_LEAVES = ['embed', 'lm_head'] + [
    f'layers/{n}' for n in ('wq', 'wk', 'wo', 'router', 'we_gate', 'we_up',
                            'we_down', 'mlp_norm')]


@pytest.fixture(scope='module')
def moe_placed():
    """mesh name -> (the JAX mesh, Mixtral's params placed by its
    ``param_shardings``), and the whole params."""
    from skypilot_tpu.models import mixtral as jax_mixtral
    cfg = jax_mixtral.PRESETS['test-tiny-moe']
    whole = jax.tree.map(np.asarray, jax.jit(jax_mixtral.MixtralModel(
        cfg).init)(jax.random.key(0)))
    out = {}
    for name, sizes in MOE_MESHES.items():
        spec = jax_mesh.MeshSpec(**sizes)
        mesh = jax_mesh.make_mesh(spec,
                                  devices=jax.devices()[:spec.num_devices])
        model = jax_mixtral.MixtralModel(cfg, mesh=mesh)
        out[name] = (mesh, jax.device_put(jax.tree.map(jnp.asarray, whole),
                                          model.param_shardings()))
    return out, whole


@pytest.mark.parametrize('mesh_name', MOE_MESHES)
def test_mixtral_keeps_the_jax_shard_of_every_leaf(moe_placed, mesh_name):
    """``MixtralModel(mesh=...)`` keeps exactly the shard of every leaf
    (experts over ep, their embed dim over fsdp and mlp dim over tp, the
    router's embed dim over fsdp) that JAX's ``param_shardings`` puts
    on the device at each coordinate; ``init`` keeps the one-device
    draw's shard."""
    from skypilot_tpu_torch.models import mixtral
    placed, whole = moe_placed
    jmesh, params = placed[mesh_name]
    cfg = mixtral.PRESETS['test-tiny-moe']
    tspec = torch_mesh.MeshSpec(**MOE_MESHES[mesh_name])
    gen = torch.Generator()
    gen.manual_seed(0)
    one = dict(_leaves(mixtral.MixtralModel(cfg, device='cpu').init(gen)))
    jleaves = dict(_leaves(params))
    for rank in range(tspec.num_devices):
        tmesh = torch_mesh.Mesh(tspec, rank)
        model = mixtral.MixtralModel(cfg, device='cpu', mesh=tmesh)
        got = dict(_leaves(model.params_from_numpy(whole)))
        device = jmesh.devices[tuple(tmesh.coords[a]
                                     for a in jmesh.axis_names)]
        for leaf in MOE_LEAVES:
            shard = next(s for s in jleaves[leaf].addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(got[leaf].numpy(),
                                          np.asarray(shard.data))
        gen.manual_seed(0)
        drawn = dict(_leaves(model.init(gen)))
        for leaf in MOE_LEAVES:
            want = torch_sharding.local_shard(one[leaf], model.specs[leaf],
                                              tmesh)
            assert torch.equal(drawn[leaf], want), leaf
    assert model.specs['layers/we_gate'] == (None, 'ep', 'fsdp', 'tp')
    assert model.specs['layers/we_down'] == (None, 'ep', 'tp', 'fsdp')
    assert model.specs['layers/router'] == (None, 'fsdp', None)


def test_run_mesh_sizing_matches_jax_arithmetic():
    def spec(argv, n, slices=1):
        return torch_run.mesh_spec(torch_run.parse_args(argv), n,
                                   slices).sizes
    assert spec([], 8) == jax_mesh.MeshSpec(fsdp=8).sizes
    assert spec(['--tp', '2', '--dp', '2'], 8) == \
        jax_mesh.MeshSpec(dp=2, fsdp=2, tp=2).sizes
    assert spec([], 8, slices=2) == jax_mesh.MeshSpec(dcn=2, fsdp=4).sizes
    assert spec(['--dcn', '1'], 8, slices=2) == \
        jax_mesh.MeshSpec(fsdp=8).sizes
    with pytest.raises(SystemExit, match=r'6 devices not divisible by '
                       r'dcn\*tp\*sp\*pp\*ep\*dp=4'):
        spec(['--tp', '4'], 6)
    with pytest.raises(SystemExit, match=r'= 4 != 8 devices'):
        spec(['--fsdp', '2', '--tp', '2'], 8)


def test_distributed_init_reads_the_contract(monkeypatch):
    """One rank builds no group; an incomplete contract and a CPU
    process asked to hold several ranks are refused."""
    from skypilot_tpu_torch.runtime import distributed
    for var in (distributed.ENV_COORDINATOR_ADDR,
                distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID,
                distributed.ENV_NUM_SLICES, distributed.ENV_SLICE_ID):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init(device_type='cpu') is False
    monkeypatch.setenv(distributed.ENV_COORDINATOR_ADDR, '127.0.0.1:1')
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, '1')
    assert distributed.init(device_type='cpu') is False
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, '2')
    with pytest.raises(ValueError, match='SKYTPU_PROCESS_ID is missing'):
        distributed.init(device_type='cpu')
    with pytest.raises(ValueError, match='one rank'):
        distributed.init(num_processes=1, local_devices=2,
                         device_type='cpu')
    monkeypatch.delenv(distributed.ENV_COORDINATOR_ADDR)
    with pytest.raises(ValueError, match='coordinator address'):
        distributed.init(process_id=0, device_type='cpu')
    assert (distributed.num_slices(), distributed.slice_id()) == (1, 0)
    monkeypatch.setenv(distributed.ENV_NUM_SLICES, '2')
    monkeypatch.setenv(distributed.ENV_SLICE_ID, '1')
    assert (distributed.num_slices(), distributed.slice_id()) == (2, 1)


def test_run_starts_workers_only_for_its_own_group(monkeypatch):
    """``train.run.main`` starts a worker per GPU only on a host with
    several, no group up and the synthetic batch; a caller's group or
    batch keeps the trainer in the calling process."""
    from skypilot_tpu_torch.runtime import distributed
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(distributed, 'is_initialized', lambda: False)
    assert torch_run.local_workers('cuda', None) == 2
    assert torch_run.local_workers('cuda', lambda step: None) == 1
    assert torch_run.local_workers('cpu', None) == 1
    monkeypatch.setattr(distributed, 'is_initialized', lambda: True)
    assert torch_run.local_workers('cuda', None) == 1
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(distributed, 'is_initialized', lambda: False)
    assert torch_run.local_workers('cuda', None) == 1


def test_collectives_bench_defaults_to_the_card(monkeypatch):
    """The bench's buffers go on the card unless the CPU is asked for:
    with no card, the default raises."""
    from skypilot_tpu_torch.ops import collectives_bench
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        collectives_bench.run_bench([0.01], iters=1, warmup=0,
                                    verbose=False)
    (rec,) = collectives_bench.run_bench([0.01], iters=1, warmup=0,
                                         device='cpu', verbose=False)
    assert (rec['ranks'], rec['busbw_gbps']) == (1, 0)
    assert rec['payload_mb'] == 0.01
