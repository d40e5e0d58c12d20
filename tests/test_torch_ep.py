"""Mixtral on a mesh in the port on the CPU (gloo): experts over ``ep``,
routing over the global token set, held against the JAX package on the
same mesh.

One spawn of 4 ranks runs every check, one process group, a mesh made
anew for each; meanwhile the parent computes the JAX references on XLA's
8 virtual CPU devices. test-tiny-moe in f32 at capacity factor 1.25, so
that assignments drop and the token set a layer routes decides which:

- ``moe_ffn`` on {ep: 2, fsdp: 2}, {ep: 2, tp: 2} and {ep: 2, sp: 2}
  (and on {ep: 2, fsdp: 2} at capacity factor 4.0, where nothing drops)
  against JAX's ``moe_ffn`` under the mesh: output, aux loss, dropped
  fraction, and the gradients of the input, the router and the experts;
  and each rank's tokens routed alone keep another set than JAX's;
- Mixtral on {ep: 2, fsdp: 2}, {ep: 2, tp: 2}, {ep: 2, sp: 2},
  {pp: 2, ep: 2} and {pp: 2, fsdp: 2}: logits, aux and gradients
  against JAX on the mesh, 3 trainer steps
  against the JAX ``Trainer`` there, leaves replicated over an axis
  identical on every rank that holds them, 3 steps from the port's own
  init against its one-device run, and each layer's slots equal across
  the ranks of an ``ep`` group (2e-5 where not stated);
- a checkpoint written on {ep: 2, fsdp: 2} resumed bit for bit on its
  mesh and restored on one device;
- ``train.run --model mixtral --ep 2`` inside the caller's group
  against one process;
then ``train.run --model mixtral --ep 2`` as 2 processes under the
SKYTPU_* contract against one.
"""
import contextlib
import dataclasses
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_mesh_helpers as h

CF = 1.25
MOE_MESHES = {'ep2_fsdp2': {'ep': 2, 'fsdp': 2},
              'ep2_tp2': {'ep': 2, 'tp': 2},
              'ep2_sp2': {'ep': 2, 'sp': 2},
              'pp2_ep2': {'pp': 2, 'ep': 2},
              'pp2_fsdp2': {'pp': 2, 'fsdp': 2}}
# moe_ffn's cases: (mesh, capacity factor).
FFN_CASES = {'ep2_fsdp2': (MOE_MESHES['ep2_fsdp2'], CF),
             'ep2_tp2': (MOE_MESHES['ep2_tp2'], CF),
             'ep2_sp2': (MOE_MESHES['ep2_sp2'], CF),
             'ep2_fsdp2_cf4': (MOE_MESHES['ep2_fsdp2'], 4.0)}
CKPT_MESH = 'ep2_fsdp2'
# moe_ffn's inputs: test-tiny-moe's widths, the batch of the model runs.
FFN_D, FFN_E, FFN_M, FFN_K, AUX_W = 64, 4, 128, 2, 10.0
Y_SIZE = h.BATCH * h.SEQ * FFN_D  # the loss is mean y² over the global y
RUN_ARGV = ['--model', 'mixtral', '--preset', 'test-tiny-moe', '--device',
            'cpu', '--batch', str(h.BATCH), '--seq', str(h.SEQ), '--steps',
            '2', '--log-every', '1']
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ffn_inputs():
    """x [B, S, D] and the layer's weights; feature 0 of x is positive
    and the router's weight from it to expert 0 large, so that expert 0
    is most tokens' first choice and overflows at CF."""
    rng = np.random.default_rng(5)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x = normal(h.BATCH, h.SEQ, FFN_D)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    router = normal(FFN_D, FFN_E, scale=FFN_D ** -0.5)
    router[0, 0] += 1.0
    return {'x': x, 'router': router,
            'gate': normal(FFN_E, FFN_D, FFN_M, scale=FFN_D ** -0.5),
            'up': normal(FFN_E, FFN_D, FFN_M, scale=FFN_D ** -0.5),
            'down': normal(FFN_E, FFN_M, FFN_D, scale=FFN_M ** -0.5)}


@dataclasses.dataclass
class _Place:
    """A rank's blocks: rows, sequence, experts and mlp columns."""
    rows: slice
    seq: slice
    experts: slice
    mlp: slice


def _place(mesh):
    from skypilot_tpu_torch.parallel.sharding import DEFAULT_RULES

    def block(n, logical):
        axes = mesh.live(DEFAULT_RULES.axes(logical))
        size = n // mesh.size(axes)
        i = mesh.index(axes)
        return slice(i * size, (i + 1) * size)
    return _Place(block(h.BATCH, 'batch'), block(h.SEQ, 'seq'),
                  block(FFN_E, 'expert'), block(FFN_M, 'mlp'))


# -- the ranks ----------------------------------------------------------------
def _rank_main(rank, port, inputs, out_dir):
    h.init_rank(rank, port)
    out = {}
    for name, (sizes, cf) in FFN_CASES.items():
        out[f'ffn_{name}'] = _ffn_case(sizes, cf, inputs['ffn'])
    for name, sizes in MOE_MESHES.items():
        mesh_dir = os.path.join(out_dir, name)
        out[name] = h.llama_mesh_checks(
            sizes, inputs, mesh_dir if name == CKPT_MESH else None,
            family='mixtral', cf=CF)
        out[name]['slots'] = _slots(sizes, inputs)
    out['resume'] = _resume_case(MOE_MESHES[CKPT_MESH], inputs,
                                 os.path.join(out_dir, CKPT_MESH, 'ckpt'))
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    with _preset_cf(CF):
        res = run.main(RUN_ARGV + ['--ep', '2', '--fsdp', '2'],
                       batch_fn=lambda step: tokens)
    out['run_main'] = [r['loss'] for r in res['log']]
    torch.save(out, f'{out_dir}/rank{rank}.pt')
    from skypilot_tpu_torch.runtime import distributed
    distributed.shutdown()


def _ffn_case(sizes, cf, arrays):
    """moe_ffn on this rank's blocks: the output block, aux, dropped
    fraction and the gradients of (sum y^2 / Y_SIZE + AUX_W aux) with
    respect to the input block, the router and the rank's expert slices;
    and the kept (token, choice) set of this rank's tokens routed
    alone."""
    from skypilot_tpu_torch.ops import moe
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    on = moe.MoeMesh(mesh, mesh.live(('dp', 'fsdp')), mesh.live('sp'),
                     mesh.live('ep'), mesh.live('tp'))
    p = _place(mesh)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x = t['x'][p.rows, p.seq].clone().requires_grad_()
    router = t['router'].clone().requires_grad_()
    gate = t['gate'][p.experts, :, p.mlp].clone().requires_grad_()
    up = t['up'][p.experts, :, p.mlp].clone().requires_grad_()
    down = t['down'][p.experts, p.mlp].clone().requires_grad_()
    y, aux = moe.moe_ffn(x, router, gate, up, down, FFN_K, cf, on=on)
    loss = (y ** 2).sum() / Y_SIZE + AUX_W * aux['aux_loss']
    grads = torch.autograd.grad(loss, (x, router, gate, up, down))
    # The same tokens routed alone: capacity from this rank's count.
    logits = x.detach().reshape(-1, FFN_D) @ t['router']
    cap = moe.expert_capacity(logits.shape[0], FFN_E, FFN_K, cf)
    dest, _, _ = moe.top_k_routing(logits, FFN_K, cap)
    return {'coords': mesh.coords, 'place': p, 'y': y.detach(),
            'aux': float(aux['aux_loss'].detach()),
            'dropped': float(aux['dropped_frac']),
            'grads': dict(zip(('x', 'router', 'gate', 'up', 'down'),
                              grads)),
            'alone_kept': _kept_pairs(dest, FFN_E * cap, cap, p.rows,
                                      p.seq)}


def _kept_pairs(dest, sink, cap, rows, seq):
    """{(global row, position, expert)} of the kept assignments in
    ``dest`` [k, b*s] (slots of a queue of ``cap``)."""
    s = seq.stop - seq.start
    out = set()
    for k, n in zip(*np.nonzero((dest < sink).numpy())):
        i, j = divmod(int(n), s)
        out.add((rows.start + i, seq.start + j, int(dest[k, n]) // cap))
    return out


@contextlib.contextmanager
def _recorded_slots():
    """``moe.top_k_routing`` recording each call's slots in the list it
    yields."""
    from skypilot_tpu_torch.ops import moe
    plain, dests = moe.top_k_routing, []

    def recorded(*args, **kwargs):
        out = plain(*args, **kwargs)
        dests.append(out[0].clone())
        return out
    moe.top_k_routing = recorded
    try:
        yield dests
    finally:
        moe.top_k_routing = plain


def _slots(sizes, inputs):
    """Each layer's slots ([k, tokens] of this rank) in the first
    batch's forward from the JAX weights."""
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    from skypilot_tpu_torch.train.step import Trainer
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    trainer = Trainer(h.torch_model('mixtral', mesh, CF))
    params = trainer.model.params_from_numpy(inputs['params'])
    tokens = torch.from_numpy(inputs['batches'][0])
    batch = trainer.shard_batch({'tokens': tokens})
    with _recorded_slots() as dests, torch.no_grad():
        trainer.model.apply_with_aux(params, batch['tokens'])
    return dests


def _resume_case(sizes, inputs, ckpt):
    """Restore step 2 of the mesh's checkpoint into a fresh state and
    take step 3 again."""
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    trainer = Trainer(h.torch_model('mixtral', mesh, CF))
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


@contextlib.contextmanager
def _preset_cf(cf):
    """test-tiny-moe at capacity factor ``cf`` for the entry points,
    which read the preset by name."""
    from skypilot_tpu_torch.models import mixtral
    full = mixtral.PRESETS['test-tiny-moe']
    mixtral.PRESETS['test-tiny-moe'] = dataclasses.replace(
        full, capacity_factor=cf)
    try:
        yield
    finally:
        mixtral.PRESETS['test-tiny-moe'] = full


# -- the references -----------------------------------------------------------
def _jax_ffn(sizes, cf, arrays):
    """JAX's moe_ffn on the mesh, its inputs laid out by the rules."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from skypilot_tpu.ops.moe import moe_ffn, top_k_routing
    from skypilot_tpu.parallel import MeshSpec, make_mesh
    from skypilot_tpu.parallel.sharding import DEFAULT_RULES
    spec = MeshSpec(**sizes)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.num_devices])

    def put(a, *axes):
        return jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, DEFAULT_RULES.spec(*axes)))

    def loss(x, router, gate, up, down):
        y, aux = moe_ffn(x, router, gate, up, down, top_k=FFN_K,
                         capacity_factor=cf)
        return (y ** 2).sum() / Y_SIZE + AUX_W * aux['aux_loss'], (y, aux)

    with jax.set_mesh(mesh):
        args = (put(arrays['x'], 'batch', 'seq', 'act_embed'),
                put(arrays['router'], 'embed', None),
                put(arrays['gate'], 'expert', 'embed', 'mlp'),
                put(arrays['up'], 'expert', 'embed', 'mlp'),
                put(arrays['down'], 'expert', 'mlp', 'embed'))
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(5)), has_aux=True))(*args)
    n = h.BATCH * h.SEQ
    logits = (jnp.asarray(arrays['x']).reshape(n, FFN_D)
              @ jnp.asarray(arrays['router']))
    from skypilot_tpu.ops.moe import expert_capacity
    cap = expert_capacity(n, FFN_E, FFN_K, cf)
    dispatch = np.asarray(top_k_routing(logits, FFN_K, cap)[0])
    kept = {(int(t) // h.SEQ, int(t) % h.SEQ, int(e))
            for t, e in zip(*np.nonzero(dispatch.sum(-1)))}
    return {'y': np.asarray(y), 'aux': float(aux['aux_loss']),
            'dropped': float(aux['dropped_frac']),
            'grads': dict(zip(('x', 'router', 'gate', 'up', 'down'),
                              (np.asarray(g) for g in grads))),
            'kept': kept}


def _one_process_run():
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(h.batches(256)[0])
    with _preset_cf(CF):
        return [r['loss'] for r in run.main(
            RUN_ARGV, batch_fn=lambda step: tokens)['log']]


def _accum_of(sizes):
    """The accumulation steps of the one-device run a mesh run
    computes: under pp the global batch is routed as its pipeline
    microbatches (one per stage), which one device routes as
    accumulation microbatches of the same rows."""
    return sizes.get('pp', 1)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the ranks' results, the JAX references, the port's one-device
    runs by accumulation steps, one-process ``train.run`` losses, the
    output dir)."""
    params = h.jax_tiny_params('mixtral')
    vocab = params['embed'].shape[0]
    inputs = {'params': params, 'batches': h.batches(vocab),
              'ffn': _ffn_inputs()}
    out_dir = str(tmp_path_factory.mktemp('ep'))
    ctx = h.spawn(_rank_main, (h.free_port(), inputs, out_dir))
    refs = {f'ffn_{name}': _jax_ffn(sizes, cf, inputs['ffn'])
            for name, (sizes, cf) in FFN_CASES.items()}
    # Three meshes at a time: XLA compiles outside the GIL.
    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(h.jax_llama_reference, sizes, params,
                                  inputs['batches'], 'mixtral', CF,
                                  step_grads=True)
                for name, sizes in MOE_MESHES.items()}
        refs.update({name: job.result() for name, job in jobs.items()})
    one = {accum: h.one_device_run(vocab, 'mixtral', CF, accum)
           for accum in {_accum_of(sizes) for sizes in MOE_MESHES.values()}}
    one_run = _one_process_run()
    h.join(ctx)
    return h.load_ranks(out_dir), refs, one, one_run, out_dir


# -- moe_ffn ------------------------------------------------------------------
@pytest.fixture(params=list(FFN_CASES))
def ffn_run(request, runs):
    name = request.param
    return (FFN_CASES[name], runs[1][f'ffn_{name}'],
            [r[f'ffn_{name}'] for r in runs[0]])


def test_moe_ffn_matches_jax_on_the_mesh(ffn_run):
    """Each rank's output block, the aux loss and the dropped fraction
    (equal to JAX's); at CF assignments drop, at 4.0 (E/k = 2) none."""
    (_, cf), ref, ranks = ffn_run
    assert ref['dropped'] > 0.05 if cf == CF else ref['dropped'] == 0
    for r in ranks:
        p = r['place']
        h.close(r['y'], ref['y'][p.rows, p.seq])
        h.close(r['aux'], ref['aux'])
        assert r['dropped'] == pytest.approx(ref['dropped'], abs=1e-7)


def test_moe_ffn_grads_match_jax_on_the_mesh(ffn_run):
    """The input block's gradient on each rank; the router's summed
    over the token blocks (once per block: the ep and tp ranks of a
    block hold the same whole gradient); each expert slice's summed
    over the token blocks."""
    (sizes, _), ref, ranks = ffn_run
    for r in ranks:
        p = r['place']
        h.close(r['grads']['x'], ref['grads']['x'][p.rows, p.seq])
    token_axes = [a for a in ('fsdp', 'sp') if sizes.get(a, 1) > 1]
    router, experts = {}, {}
    for r in ranks:
        block = tuple(r['coords'][a] for a in token_axes)
        got = r['grads']['router']
        if block in router:
            assert torch.equal(router[block], got)
        router[block] = got
        p = r['place']
        for name, index in (('gate', (p.experts, slice(None), p.mlp)),
                            ('up', (p.experts, slice(None), p.mlp)),
                            ('down', (p.experts, p.mlp))):
            key = (name, p.experts.start, p.mlp.start)
            experts.setdefault(key, [index, {}])[1][block] = r['grads'][name]
    h.close(sum(router.values()), ref['grads']['router'])
    for (name, _, _), (index, parts) in experts.items():
        h.close(sum(parts.values()), ref['grads'][name][index])


def test_routing_each_ranks_tokens_alone_keeps_another_set(runs):
    """On {ep: 2, fsdp: 2} at CF, a rank routing its own tokens (its
    capacity from its count) keeps other (token, expert) assignments
    than JAX's global routing; the port's global routing keeps JAX's
    (its output and dropped fraction equal JAX's above)."""
    ranks, refs = runs[0], runs[1]
    name = 'ffn_ep2_fsdp2'
    kept = refs[name]['kept']
    alone = set()
    for r in ranks:
        alone |= r[name]['alone_kept']
    assert alone != kept
    assert len(kept) == round((1 - refs[name]['dropped'])
                              * FFN_K * h.BATCH * h.SEQ)


# -- Mixtral on the meshes ----------------------------------------------------
@pytest.fixture(params=list(MOE_MESHES))
def mesh_run(request, runs):
    name = request.param
    sizes = MOE_MESHES[name]
    return (sizes, runs[1][name], [r[name] for r in runs[0]],
            runs[2][_accum_of(sizes)])


def test_mixtral_logits_and_aux_match_jax_on_the_mesh(mesh_run):
    sizes, ref, ranks, _ = mesh_run
    h.check_logits(sizes, ref, ranks)
    for r in ranks:
        h.close(float(r['aux']), ref['aux'])


def test_mixtral_grads_match_jax_on_the_mesh(mesh_run):
    _, ref, ranks, _ = mesh_run
    h.check_grads(ref, ranks)


def test_three_trainer_steps_match_jax_on_the_mesh(mesh_run):
    """Losses and grad norms 1e-5, params 2e-5, except the elements
    whose gradient was within AdamW's epsilon regime in a step
    (``h.check_steps``): at capacity factor 1.25 one we_down element
    of layer 0 has a step-1 gradient of -1.3e-8, where JAX itself ends
    1.79e-5 apart on {pp: 2, ep: 2} and {pp: 2, fsdp: 2}."""
    _, ref, ranks, _ = mesh_run
    h.check_steps(ref, ranks, eps_aware=True)


def test_replicated_leaves_are_identical_across_ranks(mesh_run):
    _, _, ranks, _ = mesh_run
    h.check_replicated_identical(ranks)


def test_mesh_run_matches_the_one_device_run(mesh_run):
    _, _, ranks, one = mesh_run
    h.check_one_device(one, ranks)


def test_slots_agree_across_each_ep_group(mesh_run):
    """The ranks that differ only in their ep coordinate route their
    (shared) tokens to the same slots in every layer."""
    sizes, _, ranks, _ = mesh_run
    groups = {}
    for r in ranks:
        key = tuple(v for a, v in r['coords'].items() if a != 'ep')
        groups.setdefault(key, []).append(r['slots'])
    assert any(len(g) > 1 for g in groups.values()) == (
        sizes.get('ep', 1) > 1)
    for group in groups.values():
        assert len(group[0]) > 0
        for other in group[1:]:
            assert len(other) == len(group[0])
            for a, b in zip(group[0], other):
                assert torch.equal(a, b)


def test_expert_leaves_split_over_ep(runs):
    """On {ep: 2, fsdp: 2} each rank holds half the experts of every
    expert leaf (and half their embed dim), the router whole over ep."""
    ranks = runs[0]
    for r in ranks:
        local = r[CKPT_MESH]['local']
        assert tuple(local['layers/we_gate'].shape) == (2, 2, 32, 128)
        assert tuple(local['layers/we_down'].shape) == (2, 2, 128, 32)
        assert tuple(local['layers/router'].shape) == (2, 32, 4)
        assert r[CKPT_MESH]['specs']['layers/we_up'] == (None, 'ep', 'fsdp',
                                                         'tp')


# -- checkpoints and the entry point ------------------------------------------
def test_ep_checkpoint_resumes_bit_for_bit_on_its_mesh(runs):
    for r in runs[0]:
        rec = r['resume']
        assert rec['steps_saved'] == [1, 2, 3]
        assert rec['restored_step'] == 2
        assert rec['loss'] == r[CKPT_MESH]['metrics'][2][0]
        for name, t in r[CKPT_MESH]['local'].items():
            assert torch.equal(rec['local'][name], t), name


def test_ep_checkpoint_restores_on_one_device(runs):
    """The {ep: 2, fsdp: 2} checkpoint read whole (the trained params,
    every expert) and restored into a one-device trainer."""
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer
    ranks, out_dir = runs[0], runs[4]
    ckpt = os.path.join(out_dir, CKPT_MESH, 'ckpt')
    whole = CheckpointManager(ckpt).read()
    assert whole['step'] == 3 and whole['opt_state']['count'] == 3
    for name, want in ranks[0][CKPT_MESH]['full'].items():
        assert torch.equal(h.flat(whole['params'])[name], want), name
    one = Trainer(h.torch_model('mixtral', cf=CF))
    gen = torch.Generator()
    gen.manual_seed(1)
    state = CheckpointManager(ckpt).restore(one.init_fn()(gen))
    for name, t in h.flat(state.params).items():
        assert torch.equal(t.detach(), h.flat(whole['params'])[name])


def test_run_main_ep2_matches_one_process(runs):
    ranks, one_run = runs[0], runs[3]
    assert len(one_run) == 2
    for r in ranks:
        h.close(r['run_main'], one_run, tol=1e-5)


def test_run_main_ep2_under_the_contract_matches_one_process():
    """``python -m skypilot_tpu_torch.train.run --model mixtral --ep 2``
    as 2 processes under the SKYTPU_* contract (fsdp auto = 1: each rank
    holds 2 of the 4 experts and sees every token) against 1."""
    argv = [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
            '--model', 'mixtral', '--preset', 'test-tiny-moe', '--device',
            'cpu', '--batch', '4', '--seq', '32', '--steps', '3',
            '--log-every', '1']
    jobs = []
    for nprocs, extra in ((1, []), (2, ['--ep', '2'])):
        env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS='1',
                   SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{h.free_port()}',
                   SKYTPU_NUM_PROCESSES=str(nprocs))
        jobs.append([subprocess.Popen(
            argv + extra, cwd=REPO_ROOT,
            env=dict(env, SKYTPU_PROCESS_ID=str(i)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(nprocs)])
    outs = []
    try:
        for job in jobs:
            outs.append([])
            for proc in job:
                out, err = proc.communicate(timeout=180)
                assert proc.returncode == 0, err[-3000:]
                outs[-1].append(out)
    finally:
        for job in jobs:
            for proc in job:
                proc.kill()
    (one,), two = outs
    assert "'ep': 2" in two[0] and '[train] devices=2 procs=2' in two[0]
    assert not two[1].strip()

    def losses(text):
        return [float(x) for x in re.findall(r'loss (\d+\.\d+)', text)]
    assert len(losses(two[0])) == 3
    np.testing.assert_allclose(losses(two[0]), losses(one), atol=1e-4)
