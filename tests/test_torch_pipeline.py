"""Pipeline parallelism in the port on the CPU (gloo), held against the
JAX package on the same mesh.

One spawn of 4 ranks runs every check, one process group, a mesh made
anew for each; meanwhile the parent computes the JAX references on XLA's
8 virtual CPU devices:

- ``pipeline`` on {pp: 4} with 6 microbatches (M != S) and an aux
  output, against JAX's ``pipeline``: outputs, aux and the gradients of
  the stage weights and of the input (1e-5);
- Llama on {pp: 2, fsdp: 2} and {pp: 2, tp: 2}: logits and gradients
  against JAX on the same mesh (1e-5), 3 trainer steps against the JAX
  ``Trainer`` there (losses and grad norms 1e-5, params 2e-5), leaves
  replicated over an axis identical on every rank holding them, and 3
  steps from the port's own init against its one-device run;
- ``init`` under pp holding the one-device init's bits;
- a checkpoint written on {pp: 2, fsdp: 2} resumed bit for bit on its
  mesh, and restored on one device and on {fsdp: 4};
- ``train.run --pp 2`` inside the caller's group against one device.
Without processes: ``split_stages`` as JAX's, and sp with pp refused
with JAX's message.
"""
import os

import numpy as np
import pytest
import torch

import torch_mesh_helpers as h

LLAMA_MESHES = {'pp2_fsdp2': {'pp': 2, 'fsdp': 2},
                'pp2_tp2': {'pp': 2, 'tp': 2}}
CKPT_MESH = 'pp2_fsdp2'
PIPE_L, PIPE_D, PIPE_M, PIPE_MB = 8, 16, 6, 2
RUN_ARGV = ['--preset', 'test-tiny', '--device', 'cpu', '--batch',
            str(h.BATCH), '--seq', str(h.SEQ), '--steps', '2',
            '--log-every', '1']


def _pipe_inputs():
    rng = np.random.default_rng(3)
    return {'w': (rng.standard_normal((PIPE_L, PIPE_D, PIPE_D))
                  * 0.3).astype(np.float32),
            'x': rng.standard_normal((PIPE_M * PIPE_MB, PIPE_D)).astype(
                np.float32)}


# -- the ranks ----------------------------------------------------------------
def _rank_main(rank, port, inputs, out_dir):
    h.init_rank(rank, port)
    out = {'pipe': _pipe_case(inputs['pipe'])}
    for name, sizes in LLAMA_MESHES.items():
        mesh_dir = os.path.join(out_dir, name)
        out[name] = h.llama_mesh_checks(
            sizes, inputs, mesh_dir if name == CKPT_MESH else None)
    out['resume'] = _resume_case(LLAMA_MESHES[CKPT_MESH], inputs,
                                 os.path.join(out_dir, CKPT_MESH, 'ckpt'))
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    res = run.main(RUN_ARGV + ['--pp', '2', '--fsdp', '2'],
                   batch_fn=lambda step: tokens)
    out['run_main'] = [r['loss'] for r in res['log']]
    torch.save(out, f'{out_dir}/rank{rank}.pt')
    from skypilot_tpu_torch.runtime import distributed
    distributed.shutdown()


def _stage(params, x):
    """tanh(x @ w[i]) over the stage's layers; aux the sum of each
    layer's mean square."""
    w = params['w']
    aux = 0.0
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
        aux = aux + (x ** 2).mean()
    return x, aux


def _pipe_case(arrays):
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh, sharding
    from skypilot_tpu_torch.parallel.pipeline import pipeline
    mesh = make_mesh(MeshSpec(pp=4), 'cpu')
    s, per = mesh.index('pp'), PIPE_L // 4
    w = torch.from_numpy(arrays['w'][s * per:(s + 1) * per]).requires_grad_()
    x = torch.from_numpy(arrays['x']).requires_grad_()
    y, aux = pipeline(_stage, {'w': w}, sharding.copy_to(x, mesh, 'pp'),
                      mesh=mesh, num_microbatches=PIPE_M, with_aux=True)
    gw, gx = torch.autograd.grad((y ** 2).sum() + aux, (w, x))
    return {'stage': s, 'y': y.detach(), 'aux': float(aux), 'gw': gw,
            'gx': gx}


def _resume_case(sizes, inputs, ckpt):
    """Restore step 2 of the mesh's checkpoint into a fresh state and
    take step 3 again."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    trainer = Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu',
                                 mesh=mesh))
    mgr = CheckpointManager(ckpt)
    state = trainer.state_from_params(trainer.model.params_from_numpy(
        inputs['params']))
    state = mgr.restore(state, step=2)
    tokens = torch.from_numpy(inputs['batches'][2])
    restored = state.step
    state, m = trainer.step_fn()(state, trainer.shard_batch(
        {'tokens': tokens, 'targets': torch.roll(tokens, -1, 1)}))
    return {'steps_saved': mgr.all_steps(), 'restored_step': restored,
            'loss': float(m['loss']),
            'local': {n: t.detach().clone()
                      for n, t in h.flat(state.params).items()}}


# -- the references -----------------------------------------------------------
def _jax_pipeline(arrays):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from skypilot_tpu.parallel import (MeshSpec, make_mesh, pipeline,
                                       split_stages)
    mesh = make_mesh(MeshSpec(pp=4), devices=jax.devices()[:4])

    def stage_fn(local_w, x):
        def layer(x, w):
            x = jnp.tanh(x @ w)
            return x, (x ** 2).mean()
        x, auxs = lax.scan(layer, x, local_w)
        return x, auxs.sum()

    def loss(w, x):
        y, aux = pipeline(stage_fn, split_stages(w, 4), x, mesh=mesh,
                          num_microbatches=PIPE_M, with_aux=True)
        return (y ** 2).sum() + aux, (y, aux)

    (_, (y, aux)), (gw, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(arrays['w']),
                                             jnp.asarray(arrays['x']))
    return {'y': np.asarray(y), 'aux': float(aux), 'gw': np.asarray(gw),
            'gx': np.asarray(gx)}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the ranks' results, the JAX references, the port's one-device
    run, one-device ``train.run`` losses, the output dir)."""
    params = h.jax_tiny_params()
    vocab = params['embed'].shape[0]
    inputs = {'params': params, 'batches': h.batches(vocab),
              'pipe': _pipe_inputs()}
    out_dir = str(tmp_path_factory.mktemp('pipe'))
    ctx = h.spawn(_rank_main, (h.free_port(), inputs, out_dir))
    refs = {'pipe': _jax_pipeline(inputs['pipe'])}
    refs.update({name: h.jax_llama_reference(sizes, params,
                                             inputs['batches'])
                 for name, sizes in LLAMA_MESHES.items()})
    one = h.one_device_run(vocab)
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    one_run = [r['loss'] for r in run.main(
        RUN_ARGV, batch_fn=lambda step: tokens)['log']]
    h.join(ctx)
    return h.load_ranks(out_dir), refs, one, one_run, out_dir


def test_pipeline_matches_jax_with_aux_and_more_microbatches(runs):
    ranks, refs = runs[0], runs[1]
    want = refs['pipe']
    per = PIPE_L // 4
    for r in ranks:
        rec = r['pipe']
        h.close(rec['y'], want['y'], tol=1e-5)
        h.close(rec['aux'], want['aux'], tol=1e-5)
        h.close(rec['gx'], want['gx'], tol=1e-5)
        s = rec['stage']
        h.close(rec['gw'], want['gw'][s * per:(s + 1) * per], tol=1e-5)


def test_split_stages_matches_jax():
    import jax.numpy as jnp

    from skypilot_tpu.parallel import split_stages as jax_split
    from skypilot_tpu_torch.parallel.pipeline import split_stages
    w = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = split_stages({'a': {'w': torch.from_numpy(w)}}, 4)['a']['w']
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_split(jnp.asarray(w), 4)))
    with pytest.raises(ValueError, match='not divisible by 3 stages'):
        split_stages(torch.zeros(8, 2), 3)


@pytest.fixture(params=list(LLAMA_MESHES))
def mesh_run(request, runs):
    name = request.param
    return (LLAMA_MESHES[name], runs[1][name], [r[name] for r in runs[0]],
            runs[2])


def test_llama_logits_match_jax_on_the_mesh(mesh_run):
    sizes, ref, ranks, _ = mesh_run
    h.check_logits(sizes, ref, ranks)


def test_llama_grads_match_jax_on_the_mesh(mesh_run):
    _, ref, ranks, _ = mesh_run
    h.check_grads(ref, ranks)


def test_three_trainer_steps_match_jax_on_the_mesh(mesh_run):
    _, ref, ranks, _ = mesh_run
    h.check_steps(ref, ranks)


def test_replicated_leaves_are_identical_across_ranks(mesh_run):
    _, _, ranks, _ = mesh_run
    h.check_replicated_identical(ranks)


def test_pp_run_matches_the_one_device_run(mesh_run):
    _, _, ranks, one = mesh_run
    h.check_one_device(one, ranks)


def test_init_under_pp_holds_the_one_device_init(mesh_run):
    """Each rank's stage layers and other shards are the slices of the
    one-device init with the same seed: every layer drawn in order."""
    from skypilot_tpu_torch.parallel import Mesh, MeshSpec, local_shard
    sizes, _, ranks, one = mesh_run
    init = one[0]
    spec = MeshSpec(**sizes)
    for rank, r in enumerate(ranks):
        mesh = Mesh(spec, rank)
        assert r['specs']['layers/wq'][0] == 'pp'
        for name, t in r['seed_init'].items():
            assert torch.equal(t, local_shard(init[name], r['specs'][name],
                                              mesh)), (rank, name)


def test_pp_checkpoint_resumes_bit_for_bit_on_its_mesh(runs):
    for r in runs[0]:
        rec = r['resume']
        assert rec['steps_saved'] == [1, 2, 3]
        assert rec['restored_step'] == 2
        assert rec['loss'] == r[CKPT_MESH]['metrics'][2][0]
        for name, t in r[CKPT_MESH]['local'].items():
            assert torch.equal(rec['local'][name], t), name


def test_pp_checkpoint_restores_on_one_device_and_fsdp4(runs):
    """The {pp: 2, fsdp: 2} checkpoint read whole on one device (the
    trained params), and restored onto each rank of {fsdp: 4} (its own
    slices of every leaf and moment, no process group needed)."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.parallel import Mesh, MeshSpec, local_shard
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    ranks, out_dir = runs[0], runs[4]
    ckpt = os.path.join(out_dir, CKPT_MESH, 'ckpt')
    whole = CheckpointManager(ckpt).read()
    assert whole['step'] == 3 and whole['opt_state']['count'] == 3
    for name, want in ranks[0][CKPT_MESH]['full'].items():
        assert torch.equal(h.flat(whole['params'])[name], want), name
    one = Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu'))
    gen = torch.Generator()
    gen.manual_seed(1)
    state = CheckpointManager(ckpt).restore(one.init_fn()(gen))
    for name, t in h.flat(state.params).items():
        assert torch.equal(t.detach(), h.flat(whole['params'])[name])
    spec = MeshSpec(fsdp=4)
    for rank in range(spec.num_devices):
        mesh = Mesh(spec, rank)
        tr = Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu',
                                mesh=mesh))
        tree = CheckpointManager(ckpt).restore(tr.init_fn()(gen)).to_tree()
        for key in ('mu', 'nu'):
            for leaf, t in h.flat(tree['opt_state'][key]).items():
                want = h.flat(whole['opt_state'][key])[leaf]
                assert torch.equal(t, local_shard(want, tr.model.specs[leaf],
                                                  mesh)), (key, leaf)
        for leaf, t in h.flat(tree['params']).items():
            assert torch.equal(t, local_shard(h.flat(whole['params'])[leaf],
                                              tr.model.specs[leaf], mesh))


def test_sp_with_pp_raises_jax_message():
    """The port refuses sp with pp when the model is made; JAX when it
    is applied: the same error and message."""
    import jax
    import jax.numpy as jnp

    from skypilot_tpu.models import llama as jax_llama
    from skypilot_tpu.parallel import MeshSpec as JaxSpec
    from skypilot_tpu.parallel import make_mesh as jax_make_mesh
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.parallel import Mesh, MeshSpec
    mesh = jax_make_mesh(JaxSpec(pp=2, sp=2, fsdp=2))
    model = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'], mesh=mesh)
    params = jax.eval_shape(model.init, jax.random.key(0))
    with pytest.raises(NotImplementedError) as jax_err:
        with jax.set_mesh(mesh):
            jax.eval_shape(model.apply, params,
                           jnp.zeros((4, 16), jnp.int32))
    with pytest.raises(NotImplementedError) as err:
        LlamaModel(PRESETS['test-tiny'], device='cpu',
                   mesh=Mesh(MeshSpec(pp=2, sp=2, fsdp=2)))
    assert str(err.value) == str(jax_err.value)


def test_run_main_pp2_matches_one_device(runs):
    ranks, one_run = runs[0], runs[3]
    assert len(one_run) == 2
    for r in ranks:
        h.close(r['run_main'], one_run, tol=1e-5)
