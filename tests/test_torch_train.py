"""The port's training path against the JAX package's, on the CPU.

test-tiny in f32, the JAX weights (``jax.random.key(0)``) carried into
the port with ``params_from_numpy`` and the same numpy batches handed to
both sides: the loss, the pre-clip gradient norm and the parameters after
three AdamW steps agree to f32 round-off (the port's optimizer applies
the same update in another order; 2e-5 unless stated). Also: the remat
policies, the checkpoint manager, the launchable trainer end to end, and
a replica serving a checkpoint the trainer wrote.
"""
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.train import step as jax_step
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.ops import attention as torch_attention
from skypilot_tpu_torch.train import checkpoint as torch_checkpoint
from skypilot_tpu_torch.train import run as torch_run
from skypilot_tpu_torch.train import step as torch_step

TOL = 2e-5
CFG = torch_llama.PRESETS['test-tiny']


@pytest.fixture(scope='module')
def jax_params():
    jm = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'])
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _torch_state(trainer, np_params):
    model = trainer.model
    return trainer.state_from_params(model.params_from_numpy(np_params))


@pytest.mark.parametrize('masked', [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 33), dtype=np.float32) * 3
    targets = rng.integers(0, 33, (2, 7))
    mask = (rng.random((2, 7)) < 0.6) if masked else None
    want = jax_step.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask))
    got = torch_step.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    _close(got, want, tol=1e-6)


# (case, accum_steps, lm_head scale): at test-tiny's init the gradient
# norm is ~2, so the clip scales every step; an lm head scaled by 0.02
# gives norms below 1, which the clip must leave alone.
TRAINER_CASES = [('clipped', 1, 1.0), ('unclipped', 1, 0.02),
                 ('accum2', 2, 1.0)]


@pytest.mark.parametrize('case,accum,head_scale', TRAINER_CASES)
def test_three_trainer_steps_match_jax(jax_params, case, accum, head_scale):
    params = dict(jax_params, lm_head=jax_params['lm_head'] * head_scale)
    jtr = jax_step.Trainer(
        jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny']),
        accum_steps=accum)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                 opt_state=jtr.tx.init(jp))
    ttr = torch_step.Trainer(torch_llama.LlamaModel(CFG, device='cpu'),
                             accum_steps=accum)
    tstate = _torch_state(ttr, params)
    jstep, tstep = jtr.step_fn(), ttr.step_fn()
    rng = np.random.default_rng(11)
    for i in range(3):
        tokens = rng.integers(0, CFG.vocab_size, (4, 32))
        targets = np.roll(tokens, -1, axis=1)
        jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens, jnp.int32),
                                    'targets': jnp.asarray(targets,
                                                           jnp.int32)})
        tstate, tm = tstep(tstate, {'tokens': torch.from_numpy(tokens),
                                    'targets': torch.from_numpy(targets)})
        _close(tm['loss'], jm['loss'])
        _close(tm['grad_norm'], jm['grad_norm'])
        assert (float(tm['grad_norm']) > 1.0) == (case != 'unclipped')
        assert tstate.step == int(jstate.step) == i + 1
    for name in torch_step.leaf_names(tstate.params):
        _close(torch_step.get_leaf(tstate.params, name).detach(),
               torch_step.get_leaf(jstate.params, name))
    tree = tstate.to_tree()
    assert tree['opt_state']['count'] == 3
    # optax chain state: (clip, adamw = (scale_by_adam, ...)).
    adam = jstate.opt_state[1][0]
    _close(tree['opt_state']['mu']['layers']['wq'], adam.mu['layers']['wq'])
    _close(tree['opt_state']['nu']['layers']['wq'], adam.nu['layers']['wq'])


def test_trainer_leaves_the_models_own_parameters_frozen(jax_params):
    """The state's leaves require grad; the model's parameters (what the
    serving engine reads) keep requires_grad=False and share storage."""
    model = torch_llama.LlamaModel(CFG, device='cpu')
    state = _torch_state(torch_step.Trainer(model), jax_params)
    assert all(not p.requires_grad for p in model.parameters())
    wq = torch_step.get_leaf(state.params, 'layers/wq')
    assert wq.requires_grad and wq.data_ptr() == model.layers['wq'].data_ptr()


@pytest.mark.parametrize('policy', ['full', 'dots'])
def test_remat_policies_agree_and_save_the_flash_outputs(jax_params,
                                                         monkeypatch,
                                                         policy):
    """None / 'full' / 'dots' give the same loss and grads. Through the
    flash custom ops, 'full' runs the forward twice per layer and 'dots'
    once: it keeps K1's out and lse (cf. tests/test_compute.py)."""
    calls = {'n': 0}
    plain = torch_attention.flash_attention_fwd_reference

    def counted(*args, **kwargs):
        calls['n'] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(torch_attention, 'flash_attention_fwd_reference',
                        counted)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256,
                                                                (2, 24)))
    results = {}
    for name, cfg in (('none', CFG), (policy, dataclasses.replace(
            CFG, remat=True, remat_policy=policy))):
        trainer = torch_step.Trainer(torch_llama.LlamaModel(cfg,
                                                            device='cpu'))
        state = _torch_state(trainer, jax_params)
        calls['n'] = 0
        logits, _ = trainer.model.apply_with_aux(state.params, tokens,
                                                 force_impl='flash')
        loss = torch_step.cross_entropy_loss(logits,
                                             torch.roll(tokens, -1, 1))
        leaves = [torch_step.get_leaf(state.params, n)
                  for n in torch_step.leaf_names(state.params)]
        grads = torch.autograd.grad(loss, leaves)
        results[name] = (loss.item(), grads, calls['n'])
    layers = CFG.num_layers
    assert results['none'][2] == layers
    assert results[policy][2] == (2 * layers if policy == 'full' else layers)
    assert abs(results[policy][0] - results['none'][0]) < 1e-6
    for a, b in zip(results[policy][1], results['none'][1]):
        _close(a, b, tol=1e-6)


@pytest.mark.parametrize('policy', ['names', 'names_qkv', 'names_offload'])
def test_unported_remat_policies_raise(policy):
    cfg = dataclasses.replace(CFG, remat=True, remat_policy=policy)
    model = torch_llama.LlamaModel(cfg, device='cpu')
    model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        model.apply_with_aux(model.params(), torch.zeros(1, 4,
                                                         dtype=torch.long))


def test_config_flops_match_jax():
    for name in ('test-tiny', 'llama-1b', 'llama3-8b'):
        t, j = torch_llama.PRESETS[name], jax_llama.PRESETS[name]
        assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)
        assert t.flops_params == j.flops_params
        assert t.train_flops_per_token(8192) == j.train_flops_per_token(8192)


def test_checkpoint_save_restore_keep_and_interval(jax_params, tmp_path):
    trainer = torch_step.Trainer(torch_llama.LlamaModel(CFG, device='cpu'))
    state = _torch_state(trainer, jax_params)
    step = trainer.step_fn()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256,
                                                                (2, 16)))
    batch = {'tokens': tokens, 'targets': torch.roll(tokens, -1, 1)}
    mgr = torch_checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2,
                                             save_interval_steps=2)
    assert mgr.latest_step() is None
    saved = {}
    for _ in range(6):
        state, _ = step(state, batch)
        if mgr.save(state):
            saved[state.step] = {k: v.clone() for k, v in
                                 state.to_tree()['params']['layers'].items()}
    mgr.wait()
    assert sorted(saved) == [2, 4, 6]
    assert mgr.all_steps() == [4, 6]  # max_to_keep 2
    # Restore step 4 into a fresh state: params and AdamW moments.
    fresh = _torch_state(trainer, jax_params)
    restored = mgr.restore(fresh, step=4)
    assert restored is fresh and restored.step == 4
    for name, want in saved[4].items():
        assert torch.equal(restored.params['layers'][name], want)
    tree = restored.to_tree()
    assert tree['opt_state']['count'] == 4
    # Two more steps from the restored step-4 state reach the step-6
    # parameters bit for bit.
    for _ in range(2):
        restored, _ = step(restored, batch)
    for name, want in saved[6].items():
        assert torch.equal(restored.params['layers'][name], want)
    assert not mgr.save(state)  # step 6 is saved already
    assert mgr.save(state, step=7, force=True)
    mgr.close()
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7


def test_run_main_trains_and_resumes_on_cpu(tmp_path, capsys):
    ckpt = tmp_path / 'ckpt'
    argv = ['--preset', 'test-tiny', '--device', 'cpu', '--batch', '2',
            '--seq', '32', '--log-every', '1', '--ckpt-dir', str(ckpt),
            '--save-every', '1']
    first = torch_run.main(argv + ['--steps', '2'])
    assert [r['step'] for r in first['log']] == [1, 2]
    assert all(np.isfinite(r['loss']) for r in first['log'])
    again = torch_run.main(argv + ['--steps', '3'])
    out = capsys.readouterr().out
    assert '[train] resumed from step 2' in out
    assert '[train] step 3: loss' in out and 'tok/s global' in out
    assert again['start_step'] == 2 and [r['step'] for r in again['log']] \
        == [3]
    assert sorted(os.listdir(ckpt)) == ['1', '2', '3']


def test_run_main_synthetic_tokens_are_seeded_per_step():
    a = torch_run.synthetic_tokens(5, 2, 8, 256, 'cpu')
    assert torch.equal(a, torch_run.synthetic_tokens(5, 2, 8, 256, 'cpu'))
    assert not torch.equal(a, torch_run.synthetic_tokens(6, 2, 8, 256,
                                                         'cpu'))


@pytest.mark.parametrize('extra,match', [
    (['--model', 'mixtral'], 'not yet ported'),
    (['--tp', '2'], 'not yet ported'),
    (['--fsdp', '4'], 'not yet ported'),
    (['--preset', 'nope'], 'unknown --preset'),
])
def test_run_main_refuses_what_is_not_ported(extra, match):
    with pytest.raises(SystemExit, match=match):
        torch_run.main(['--preset', 'test-tiny', '--device', 'cpu',
                        '--steps', '1'] + extra)


def test_run_main_refuses_the_warm_init_cache(monkeypatch):
    monkeypatch.setenv('SKYTPU_WARM_INIT_CACHE', '/tmp/nowhere')
    with pytest.raises(SystemExit, match='SKYTPU_WARM_INIT_CACHE'):
        torch_run.main(['--preset', 'test-tiny', '--device', 'cpu'])


def test_replica_serves_the_weights_the_trainer_saved(tmp_path):
    """One trainer step on test-tiny, saved; the replica started with
    ``--ckpt-dir`` serves exactly those params and answers greedily as
    the trained model's own forward does."""
    from skypilot_tpu_torch.serve import generation_server as gs
    ckpt = str(tmp_path / 'ckpt')
    res = torch_run.main(['--preset', 'test-tiny', '--device', 'cpu',
                          '--batch', '2', '--seq', '16', '--steps', '1',
                          '--ckpt-dir', ckpt, '--save-every', '1'])
    trained = res['state'].params
    args = gs.build_parser().parse_args(
        ['--preset', 'test-tiny', '--device', 'cpu', '--max-len', '64',
         '--batch-slots', '2', '--ckpt-dir', ckpt])
    sched = gs.build_scheduler(args)
    for name in torch_step.leaf_names(trained):
        assert torch.equal(torch_step.get_leaf(sched.params, name),
                           torch_step.get_leaf(trained, name).detach())
    prompt = [5, 17, 200, 3]
    sched.start()
    server = gs.GenerationServer(sched, host='127.0.0.1', port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.port}/generate',
            data=json.dumps({'tokens': prompt, 'max_tokens': 3,
                             'temperature': 0.0}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        server.shutdown()
        sched._thread.join(timeout=10)
        sched._emit_thread.join(timeout=10)
    seq = list(prompt)
    for _ in range(3):
        logits = sched.engine.model.apply(sched.params,
                                          torch.tensor([seq]))
        seq.append(int(logits[0, -1].argmax()))
    assert list(got['tokens']) == seq[len(prompt):]
