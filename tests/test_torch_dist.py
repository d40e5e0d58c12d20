"""Multi-rank runs of the port on the CPU (gloo), held against the JAX
package on the same mesh.

One spawn of 4 ranks runs every check on each of three meshes in turn
({fsdp2,tp2}, {dp2,fsdp2}, and {dcn2,fsdp2} under ``multislice_rules``),
one process group, a mesh made anew for each; meanwhile the parent
computes the JAX references on XLA's 8 virtual CPU devices. The workers
get numpy arrays and import no JAX. test-tiny in f32:

- ``embed_lookup`` forward and table gradient;
- logits against the JAX forward on that mesh (1e-5);
- 3 trainer steps from the JAX weights against the JAX ``Trainer`` on
  that mesh: loss and grad norm within 1e-5, params within 2e-5 (the
  one-device parity test's bound);
- 3 steps from the port's own init (seed 0) against the port's
  one-device run (the same bits to start; 2e-5);
- leaves replicated over an axis identical on every rank holding them;
- a sharded checkpoint resumed bit for bit on its mesh, and read (and
  served, ``--ckpt-dir``) on one device;
- the remat policies on the mesh (the gathers recomputed) giving the
  same gradients.

Then ``train.run`` under the SKYTPU_* contract with 2 processes against
one process, and the collectives bench on 2 ranks. Every rendezvous
binds a free port; every rank runs one thread.
"""
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {'fsdp2_tp2': ({'fsdp': 2, 'tp': 2}, False),
          'dp2_fsdp2': ({'dp': 2, 'fsdp': 2}, False),
          'dcn2_fsdp2': ({'dcn': 2, 'fsdp': 2}, True)}
WORLD = 4
STEPS = 3
BATCH, SEQ = 4, 32
TOL = 2e-5
SPAWN_TIMEOUT_S = 180
RUN_ARGV = ['--preset', 'test-tiny', '--device', 'cpu', '--batch', str(BATCH),
            '--seq', str(SEQ), '--steps', '2', '--log-every', '1']
RUN_MESHES = (['--tp', '2', '--fsdp', '2'], ['--dp', '2'])


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _batches(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (BATCH, SEQ)) for _ in range(STEPS)]


def _flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = value
    return out


# -- the ranks ----------------------------------------------------------------
def _rank_main(rank, port, inputs, out_dir):
    """One rank: every check on every mesh; its results to out_dir."""
    torch.set_num_threads(1)
    from skypilot_tpu_torch.runtime import distributed
    distributed.init(f'127.0.0.1:{port}', WORLD, rank, device_type='cpu',
                     timeout_s=120)
    out = {name: _mesh_checks(sizes, multislice, inputs,
                              os.path.join(out_dir, name))
           for name, (sizes, multislice) in MESHES.items()}
    # train.run inside a group the caller set up (two meshes in turn, as
    # chip_smoke.py's ranks run it): the group stays up for the caller.
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    out['run_main'] = {}
    for flags in RUN_MESHES:
        res = run.main(RUN_ARGV + flags, batch_fn=lambda step: tokens)
        out['run_main'][' '.join(flags)] = (
            [r['loss'] for r in res['log']], distributed.is_initialized())
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    distributed.shutdown()


def _mesh_checks(sizes, multislice, inputs, out_dir):
    """Every check of one mesh, on this rank."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.ops.embedding import embed_lookup
    from skypilot_tpu_torch.parallel import (DEFAULT_RULES, MeshSpec,
                                             make_mesh, multislice_rules)
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    rules = multislice_rules() if multislice else DEFAULT_RULES
    cfg = PRESETS['test-tiny']
    out = {'coords': mesh.coords}

    def new_trainer(config=cfg):
        return Trainer(LlamaModel(config, device='cpu', mesh=mesh,
                                  rules=rules))

    def batch_of(tokens, trainer):
        tokens = torch.from_numpy(tokens)
        return trainer.shard_batch(
            {'tokens': tokens, 'targets': torch.roll(tokens, -1, 1)})

    def local_tree(params):
        return {n: t.detach().clone() for n, t in _flat(params).items()}

    # embed_lookup: forward rows, and the table gradient of sum(out * w).
    trainer = new_trainer()
    model = trainer.model
    params = model.params_from_numpy(inputs['params'])
    table = params['embed'].detach().clone().requires_grad_(True)
    batch = batch_of(inputs['batches'][0], trainer)
    emb = embed_lookup(table, batch['tokens'], mesh, rules)
    w = trainer.shard_batch({'w': torch.from_numpy(inputs['embed_w'])})['w']
    (grad,) = torch.autograd.grad((emb * w).sum(), table)
    trainer._sum_over_batch(['embed'], [grad])
    out['embed_out'] = emb.detach()
    out['embed_grad'] = sharding.gather_full(grad, model.specs['embed'],
                                             mesh)
    # Logits: this rank's rows and vocab shard.
    out['logits'] = model.apply(params, batch['tokens'])

    # The remat policies: the same gradients with the gathers recomputed.
    state = trainer.state_from_params(params)
    _, base = trainer.grads(state.params, batch)
    out['remat_err'] = {}
    for policy in ('full', 'dots', 'names'):
        tr = new_trainer(dataclasses.replace(cfg, remat=True,
                                             remat_policy=policy))
        st = tr.state_from_params(tr.model.params_from_numpy(
            inputs['params']))
        _, grads = tr.grads(st.params, batch)
        out['remat_err'][policy] = max(float((g - b).abs().max())
                                       for g, b in zip(grads, base))

    # 3 steps from the JAX weights, a checkpoint after each.
    ckpt = os.path.join(out_dir, 'ckpt')
    mgr = CheckpointManager(ckpt, save_interval_steps=1)
    trainer = new_trainer()
    state = trainer.state_from_params(
        trainer.model.params_from_numpy(inputs['params']))
    step = trainer.step_fn()
    out['metrics'] = []
    for tokens in inputs['batches']:
        state, m = step(state, batch_of(tokens, trainer))
        out['metrics'].append((float(m['loss']), float(m['grad_norm'])))
        mgr.save(state)
    out['local'] = local_tree(state.params)
    out['full'] = {n: t.clone() for n, t in _flat(
        trainer.model.full_params(state.params)).items()}
    out['steps_saved'] = mgr.all_steps()
    # Resume from step 2 into a fresh state: step 3 again, bit for bit.
    trainer = new_trainer()
    state = trainer.state_from_params(
        trainer.model.params_from_numpy(inputs['params']))
    state = mgr.restore(state, step=2)
    out['restored_step'] = state.step
    state, m = trainer.step_fn()(state, batch_of(inputs['batches'][2],
                                                 trainer))
    out['resumed_loss'] = float(m['loss'])
    out['resumed_local'] = local_tree(state.params)

    # 3 steps from the port's own init on the mesh (seed 0).
    trainer = new_trainer()
    gen = torch.Generator()
    gen.manual_seed(0)
    state = trainer.init_fn()(gen)
    step = trainer.step_fn()
    out['seed_losses'] = []
    for tokens in inputs['batches']:
        state, m = step(state, batch_of(tokens, trainer))
        out['seed_losses'].append(float(m['loss']))
    out['seed_full'] = {n: t.clone() for n, t in _flat(
        trainer.model.full_params(state.params)).items()}
    out['specs'] = trainer.model.specs
    return out


def _spawn(fn, args, nprocs):
    """Start ``nprocs`` ranks of ``fn(rank, *args)``."""
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method='spawn')


def _join(ctx):
    """Wait for the ranks; fail on an error or when they outlive
    SPAWN_TIMEOUT_S."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f'ranks still running after {SPAWN_TIMEOUT_S} s')


# -- the references -----------------------------------------------------------
@pytest.fixture(scope='module')
def jax_params():
    import jax

    from skypilot_tpu.models import llama as jax_llama
    jm = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'])
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


def _one_device_run():
    """The port's one-device run from seed 0 on the same batches."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.train.step import Trainer
    cfg = PRESETS['test-tiny']
    trainer = Trainer(LlamaModel(cfg, device='cpu'))
    gen = torch.Generator()
    gen.manual_seed(0)
    state = trainer.init_fn()(gen)
    step = trainer.step_fn()
    losses = []
    for tokens in _batches(cfg.vocab_size):
        tokens = torch.from_numpy(tokens)
        state, m = step(state, {'tokens': tokens,
                                'targets': torch.roll(tokens, -1, 1)})
        losses.append(float(m['loss']))
    return losses, {n: t.detach() for n, t in _flat(state.params).items()}


def _jax_reference(sizes, multislice, params, batches, w):
    import jax
    import jax.numpy as jnp

    from skypilot_tpu.models import llama as jax_llama
    from skypilot_tpu.ops.embedding import embed_lookup
    from skypilot_tpu.parallel import MeshSpec, make_mesh, multislice_rules
    from skypilot_tpu.parallel.sharding import DEFAULT_RULES
    from skypilot_tpu.train import step as jax_step
    spec = MeshSpec(**sizes)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.num_devices])
    rules = multislice_rules() if multislice else DEFAULT_RULES
    model = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'], mesh=mesh,
                                 rules=rules)
    ref = {}
    with jax.set_mesh(mesh):
        jp = jax.device_put(jax.tree.map(jnp.asarray, params),
                            model.param_shardings())
        tok = jnp.asarray(batches[0], jnp.int32)

        def emb_loss(table):
            return jnp.sum(embed_lookup(table, tok, mesh, rules) * w)
        ref['embed_out'] = np.asarray(jax.jit(
            lambda t: embed_lookup(t, tok, mesh, rules))(jp['embed']))
        ref['embed_grad'] = np.asarray(jax.jit(jax.grad(emb_loss))(
            jp['embed']))
        ref['logits'] = np.asarray(jax.jit(model.apply)(jp, tok))
        trainer = jax_step.Trainer(model)
        state = jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                    opt_state=trainer.tx.init(jp))
        step = trainer.step_fn()
        ref['metrics'] = []
        for tokens in batches:
            tokens = jnp.asarray(tokens, jnp.int32)
            state, m = step(state, trainer.shard_batch(
                {'tokens': tokens, 'targets': jnp.roll(tokens, -1, 1)}))
            ref['metrics'].append((float(m['loss']), float(m['grad_norm'])))
        ref['params'] = _flat(jax.tree.map(np.asarray, state.params))
    return ref


@pytest.fixture(scope='module')
def dist_runs(jax_params, tmp_path_factory):
    """(the port's one-device run, {mesh name -> (JAX reference, the
    ranks' results, checkpoint dir)}, (one-device ``train.run`` losses,
    each rank's in-group ``train.run`` results)): the ranks run while JAX
    compiles and the one-device runs train."""
    vocab = jax_params['embed'].shape[0]
    batches = _batches(vocab)
    w = np.random.default_rng(5).standard_normal(
        (BATCH, SEQ, jax_params['embed'].shape[1])).astype(np.float32)
    out_dir = str(tmp_path_factory.mktemp('dist'))
    inputs = {'params': jax_params, 'batches': batches, 'embed_w': w}
    ctx = _spawn(_rank_main, (_free_port(), inputs, out_dir), WORLD)
    refs = {name: _jax_reference(sizes, multislice, jax_params, batches, w)
            for name, (sizes, multislice) in MESHES.items()}
    one = _one_device_run()
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(batches[0])
    one_run = [r['loss'] for r in run.main(
        RUN_ARGV, batch_fn=lambda step: tokens)['log']]
    _join(ctx)
    ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                        weights_only=False) for r in range(WORLD)]
    runs = {name: (refs[name], [r[name] for r in ranks],
                   os.path.join(out_dir, name, 'ckpt')) for name in MESHES}
    return one, runs, (one_run, [r['run_main'] for r in ranks])


@pytest.fixture(params=list(MESHES))
def mesh_run(request, dist_runs):
    """(mesh name, JAX reference, the ranks' results, checkpoint dir)."""
    return (request.param,) + dist_runs[1][request.param]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _assemble(ranks, key, batch_axes, vocab_axes):
    """The global [B, S, ...] array from each rank's rows (and vocab
    shard, when ``vocab_axes``), placed by the ranks' coordinates."""
    def index(coords, axes):
        i = 0
        for a in axes:
            i = i * 2 + coords[a]  # every live axis here has size 2
        return i
    n_b = 2 ** len(batch_axes)
    n_v = 2 ** len(vocab_axes)
    rows = ranks[0][key].shape[0]
    cols = ranks[0][key].shape[-1]
    shape = (rows * n_b,) + tuple(ranks[0][key].shape[1:-1]) + (cols * n_v,)
    full = torch.zeros(shape)
    for r in ranks:
        b = index(r['coords'], batch_axes)
        v = index(r['coords'], vocab_axes)
        full[b * rows:(b + 1) * rows, ..., v * cols:(v + 1) * cols] = r[key]
    return full.numpy()


def _live(name, logical):
    sizes, multislice = MESHES[name]
    axes = {'batch': (('dcn',) if multislice else ()) + ('dp', 'fsdp'),
            'vocab': ('tp',)}[logical]
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def test_embed_lookup_matches_jax(mesh_run):
    name, ref, ranks, _ = mesh_run
    got = _assemble(ranks, 'embed_out', _live(name, 'batch'), ())
    _close(got, ref['embed_out'], tol=1e-6)
    for r in ranks:
        _close(r['embed_grad'], ref['embed_grad'], tol=1e-5)


def test_logits_match_jax_forward_on_the_mesh(mesh_run):
    name, ref, ranks, _ = mesh_run
    got = _assemble(ranks, 'logits', _live(name, 'batch'),
                    _live(name, 'vocab'))
    _close(got, ref['logits'], tol=1e-5)


def test_three_trainer_steps_match_jax_on_the_mesh(mesh_run):
    _, ref, ranks, _ = mesh_run
    for r in ranks:
        for (loss, norm), (jloss, jnorm) in zip(r['metrics'],
                                                ref['metrics']):
            _close(loss, jloss, tol=1e-5)
            _close(norm, jnorm, tol=1e-5)
    for name, want in ref['params'].items():
        _close(ranks[0]['full'][name], want)


def test_sharded_run_matches_the_one_device_run(mesh_run, dist_runs):
    _, _, ranks, _ = mesh_run
    losses, params = dist_runs[0]
    for r in ranks:
        _close(r['seed_losses'], losses, tol=1e-5)
    for name, want in params.items():
        _close(ranks[0]['seed_full'][name], want)


def test_replicated_leaves_are_identical_across_ranks(mesh_run):
    """Ranks that hold the same slice of a leaf (equal coordinates on
    the axes that split it) hold the same bits after 3 steps."""
    from skypilot_tpu_torch.parallel.sharding import spec_axes
    _, _, ranks, _ = mesh_run
    compared = 0
    for name, spec in ranks[0]['specs'].items():
        split = spec_axes(spec)
        groups = {}
        for r in ranks:
            key = tuple(r['coords'][a] for a in split)
            groups.setdefault(key, []).append(r['local'][name])
        for copies in groups.values():
            for t in copies[1:]:
                assert torch.equal(t, copies[0]), name
                compared += 1
    assert compared >= 2 * 3  # at least the three norms, on two ranks


def test_sharded_checkpoint_resumes_bit_for_bit_on_its_mesh(mesh_run):
    _, _, ranks, ckpt = mesh_run
    for r in ranks:
        assert r['steps_saved'] == [1, 2, 3]
        assert r['restored_step'] == 2
        assert r['resumed_loss'] == r['metrics'][2][0]
        for name, t in r['local'].items():
            assert torch.equal(r['resumed_local'][name], t), name
    files = sorted(os.listdir(os.path.join(ckpt, '3')))
    assert 'index.json' in files and 'shards-00000.pt' in files


def test_sharded_checkpoint_reads_and_serves_on_one_device(mesh_run):
    """One device assembles the whole tree; a one-device replica started
    with ``--ckpt-dir`` serves exactly the trained params."""
    from skypilot_tpu_torch.serve import generation_server as gs
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    _, _, ranks, ckpt = mesh_run
    tree = CheckpointManager(ckpt).read()
    assert tree['step'] == 3 and tree['opt_state']['count'] == 3
    for name, want in ranks[0]['full'].items():
        assert torch.equal(_flat(tree['params'])[name], want), name
    args = gs.build_parser().parse_args(
        ['--preset', 'test-tiny', '--device', 'cpu', '--max-len', '64',
         '--batch-slots', '2', '--ckpt-dir', ckpt])
    sched = gs.build_scheduler(args)
    for name, want in ranks[0]['full'].items():
        assert torch.equal(_flat(sched.params)[name], want), name


OTHER_MESH = {'fsdp2_tp2': {'dp': 2, 'tp': 2},
              'dp2_fsdp2': {'fsdp': 2, 'tp': 2},
              'dcn2_fsdp2': {'fsdp': 4}}


def test_sharded_checkpoint_restores_on_another_mesh(mesh_run, tmp_path):
    """Each rank of another mesh restores its own slices of every leaf
    and moment (no process group needed to read); a one-device
    checkpoint restores onto a mesh rank the same way."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.parallel import Mesh, MeshSpec, local_shard
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    name, _, ranks, ckpt = mesh_run
    whole = CheckpointManager(ckpt).read()
    one = Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu'))
    single = CheckpointManager(str(tmp_path / 'one'))
    single.save(one.state_from_params(one.model.params_from_numpy(
        whole['params'])), step=3, force=True)
    single.wait()
    spec = MeshSpec(**OTHER_MESH[name])
    for rank in range(spec.num_devices):
        mesh = Mesh(spec, rank)
        tr = Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu',
                                mesh=mesh))
        gen = torch.Generator()
        gen.manual_seed(1)
        state = CheckpointManager(ckpt).restore(tr.init_fn()(gen))
        tree = state.to_tree()
        assert state.step == 3 and tree['opt_state']['count'] == 3
        for key in ('params', 'opt_state/mu', 'opt_state/nu'):
            got = _flat(tree['params'] if key == 'params' else
                        tree['opt_state'][key.split('/')[1]])
            want = _flat(whole['params'] if key == 'params' else
                         whole['opt_state'][key.split('/')[1]])
            for leaf, t in got.items():
                assert torch.equal(t, local_shard(want[leaf],
                                                  tr.model.specs[leaf],
                                                  mesh)), (key, leaf)
        state = single.restore(tr.init_fn()(gen))
        for leaf, t in _flat(state.to_tree()['params']).items():
            assert torch.equal(t, local_shard(_flat(whole['params'])[leaf],
                                              tr.model.specs[leaf], mesh))


def test_remat_policies_give_the_same_grads_on_the_mesh(mesh_run):
    _, _, ranks, _ = mesh_run
    for r in ranks:
        for policy, err in r['remat_err'].items():
            assert err <= 1e-6, (policy, err)


def test_run_main_in_a_callers_group_leaves_it_up(dist_runs):
    """``train.run.main`` on two meshes in turn inside one group the
    caller made: the same losses as one device, and the group still up
    after each run."""
    one_run, ranks = dist_runs[2]
    assert len(one_run) == 2
    for runs in ranks:
        assert len(runs) == len(RUN_MESHES)
        for losses, still_up in runs.values():
            assert still_up
            _close(losses, one_run, tol=1e-5)


# -- the launchable entry points under the SKYTPU_* contract -----------------
def _contract_run(module_args, *jobs, timeout=180):
    """Run ``python -m <module_args>`` as one job of ``n`` processes
    under the rank contract for each ``n`` in ``jobs``, all at once;
    returns each job's stdouts."""
    procs = []
    for nprocs in jobs:
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS='1',
                   SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{_free_port()}',
                   SKYTPU_NUM_PROCESSES=str(nprocs))
        procs.append([subprocess.Popen(
            [sys.executable, '-m'] + module_args, cwd=REPO_ROOT,
            env=dict(env, SKYTPU_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(nprocs)])
    outs = []
    try:
        for job in procs:
            outs.append([])
            for proc in job:
                out, err = proc.communicate(timeout=timeout)
                assert proc.returncode == 0, err[-3000:]
                outs[-1].append(out)
    finally:
        for job in procs:
            for proc in job:
                proc.kill()
    return outs


def test_run_main_two_processes_match_one_process():
    argv = ['skypilot_tpu_torch.train.run', '--preset', 'test-tiny',
            '--device', 'cpu', '--fsdp', 'auto', '--batch', '4', '--seq',
            '32', '--steps', '3', '--log-every', '1']
    one, two = _contract_run(argv, 1, 2)
    one = one[0]
    assert '[train] devices=2 procs=2 mesh=' in two[0]
    assert "'fsdp': 2" in two[0] and '[train] devices=1 procs=1' in one
    assert not two[1].strip()  # only rank 0 prints

    def losses(text):
        return [float(x) for x in re.findall(r'loss (\d+\.\d+)', text)]
    assert len(losses(two[0])) == 3
    np.testing.assert_allclose(losses(two[0]), losses(one), atol=1e-4)


def test_collectives_bench_on_two_ranks():
    (outs,) = _contract_run(['skypilot_tpu_torch.ops.collectives_bench',
                             '--device', 'cpu', '--sizes-mb', '0.5', '2',
                             '--iters', '3'], 2)
    rec = json.loads(outs[0].strip().splitlines()[-1])
    assert rec['predicted_bisection_gbps'] is None
    assert [r['ranks'] for r in rec['allreduce']] == [2, 2]
    assert [r['payload_mb'] for r in rec['allreduce']] == [0.5, 2.0]
    for r in rec['allreduce']:
        assert r['busbw_gbps'] == pytest.approx(r['algbw_gbps'], rel=1e-2)
        assert r['time_ms'] > 0
