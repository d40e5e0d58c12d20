"""Helpers of the port's multi-rank CPU tests (``tests/test_torch_ring.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_ep.py``): gloo
ranks spawned from the test process, the model checks each rank runs on
a mesh, and the JAX references on XLA's virtual CPU devices (conftest).
The ranks get numpy arrays and import no JAX. test-tiny (Llama) or
test-tiny-moe (Mixtral, ``family='mixtral'``, its capacity factor
optionally replaced) in f32.
"""
import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
STEPS = 3
BATCH, SEQ = 4, 32
TOL = 2e-5
SPAWN_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def spawn(fn, args, nprocs=WORLD):
    """Start ``nprocs`` ranks of ``fn(rank, *args)``."""
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method='spawn')


def join(ctx):
    """Wait for the ranks; fail on an error or when they outlive
    SPAWN_TIMEOUT_S."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f'ranks still running after {SPAWN_TIMEOUT_S} s')


def init_rank(rank, port):
    torch.set_num_threads(1)
    from skypilot_tpu_torch.runtime import distributed
    distributed.init(f'127.0.0.1:{port}', WORLD, rank, device_type='cpu',
                     timeout_s=120)


def load_ranks(out_dir):
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(WORLD)]


def flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = value
    return out


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def batches(vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (BATCH, SEQ)) for _ in range(STEPS)]


def torch_model(family='llama', mesh=None, cf=None):
    """The port's test-tiny model of ``family`` on the CPU (Mixtral at
    capacity factor ``cf`` when given)."""
    if family == 'mixtral':
        from skypilot_tpu_torch.models import mixtral
        cfg = mixtral.PRESETS['test-tiny-moe']
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        return mixtral.MixtralModel(cfg, device='cpu', mesh=mesh)
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    return LlamaModel(PRESETS['test-tiny'], device='cpu', mesh=mesh)


def jax_model(family='llama', mesh=None, cf=None):
    """The JAX package's counterpart of ``torch_model``."""
    if family == 'mixtral':
        from skypilot_tpu.models import mixtral
        cfg = mixtral.PRESETS['test-tiny-moe']
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        return mixtral.MixtralModel(cfg, mesh=mesh)
    from skypilot_tpu.models import llama as jax_llama
    return jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'], mesh=mesh)


def jax_tiny_params(family='llama'):
    import jax
    jm = jax_model(family)
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


def assemble(ranks, key, sizes, dim_axes):
    """The global array from each rank's block of ``key``: dim d of the
    block is split over the mesh axes ``dim_axes[d]`` (axes of size 1
    dropped), placed by the ranks' coordinates."""
    block = ranks[0][key]
    dims = [tuple(a for a in axes if sizes.get(a, 1) > 1)
            for axes in dim_axes]
    parts = [int(np.prod([sizes[a] for a in axes])) for axes in dims]
    shape = [n * parts[d] if d < len(dims) else n
             for d, n in enumerate(block.shape)]
    full = torch.zeros(shape, dtype=block.dtype)
    for r in ranks:
        index = []
        for d, axes in enumerate(dims):
            i = 0
            for a in axes:
                i = i * sizes[a] + r['coords'][a]
            n = block.shape[d]
            index.append(slice(i * n, (i + 1) * n))
        full[tuple(index)] = r[key]
    return full.numpy()


# -- the ranks' checks of one mesh -------------------------------------------
def llama_mesh_checks(sizes, inputs, out_dir=None, family='llama', cf=None):
    """On this rank, on the mesh ``sizes``: logits of the first batch,
    the gradients of its loss (whole, gathered), 3 trainer steps from
    the JAX weights (a checkpoint after each into ``out_dir``), and 3
    from the port's own init (seed 0). 'rows' holds the global rows of
    the batch this rank trains on (``Trainer.row_index``)."""
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh, sharding
    from skypilot_tpu_torch.train.checkpoint import CheckpointManager
    from skypilot_tpu_torch.train.step import Trainer, leaf_names
    mesh = make_mesh(MeshSpec(**sizes), 'cpu')
    out = {'coords': mesh.coords}

    def new_trainer():
        return Trainer(torch_model(family, mesh, cf))

    def batch_of(tokens, trainer):
        tokens = torch.from_numpy(tokens)
        return trainer.shard_batch(
            {'tokens': tokens, 'targets': torch.roll(tokens, -1, 1)})

    trainer = new_trainer()
    model = trainer.model
    out['rows'] = trainer.row_index(BATCH)
    state = trainer.state_from_params(model.params_from_numpy(
        inputs['params']))
    batch = batch_of(inputs['batches'][0], trainer)
    with torch.no_grad():
        out['logits'], out['aux'] = model.apply_with_aux(state.params,
                                                         batch['tokens'])
    loss, grads = trainer.grads(state.params, batch)
    out['loss'] = float(loss)
    out['grads'] = {n: sharding.gather_full(g, model.specs[n], mesh)
                    for n, g in zip(leaf_names(state.params), grads)}

    mgr = (CheckpointManager(os.path.join(out_dir, 'ckpt'),
                             save_interval_steps=1) if out_dir else None)
    step = trainer.step_fn()
    out['metrics'] = []
    for tokens in inputs['batches']:
        state, m = step(state, batch_of(tokens, trainer))
        out['metrics'].append((float(m['loss']), float(m['grad_norm'])))
        if mgr is not None:
            mgr.save(state)
    out['local'] = {n: t.detach().clone()
                    for n, t in flat(state.params).items()}
    out['full'] = {n: t.clone() for n, t in flat(
        model.full_params(state.params)).items()}
    out['specs'] = model.specs

    trainer = new_trainer()
    gen = torch.Generator()
    gen.manual_seed(0)
    state = trainer.init_fn()(gen)
    out['seed_init'] = {n: t.detach().clone()
                        for n, t in flat(state.params).items()}
    step = trainer.step_fn()
    out['seed_losses'] = []
    for tokens in inputs['batches']:
        state, m = step(state, batch_of(tokens, trainer))
        out['seed_losses'].append(float(m['loss']))
    out['seed_full'] = {n: t.clone() for n, t in flat(
        trainer.model.full_params(state.params)).items()}
    return out


def one_device_run(vocab, family='llama', cf=None, accum=1, seed=11):
    """The port's one-device run from seed 0 on ``batches(vocab, seed)``
    (in ``accum`` accumulation microbatches): (its init, its losses, its
    params after the steps)."""
    from skypilot_tpu_torch.train.step import Trainer
    trainer = Trainer(torch_model(family, cf=cf), accum_steps=accum)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = trainer.init_fn()(gen)
    init = {n: t.detach().clone() for n, t in flat(state.params).items()}
    step = trainer.step_fn()
    losses = []
    for tokens in batches(vocab, seed):
        tokens = torch.from_numpy(tokens)
        state, m = step(state, {'tokens': tokens,
                                'targets': torch.roll(tokens, -1, 1)})
        losses.append(float(m['loss']))
    return init, losses, {n: t.detach() for n, t in flat(
        state.params).items()}


def jax_llama_reference(sizes, params, token_batches, family='llama',
                        cf=None, step_grads=False):
    """The JAX model and trainer on the mesh ``sizes`` from ``params``:
    the first batch's logits, aux and loss gradients (the loss with the
    aux term, as the trainer's), then 3 steps (with ``step_grads``, the
    gradients each step takes)."""
    import jax
    import jax.numpy as jnp

    from skypilot_tpu.parallel import MeshSpec, make_mesh
    from skypilot_tpu.train import step as jax_step
    spec = MeshSpec(**sizes)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.num_devices])
    model = jax_model(family, mesh, cf)
    ref = {}
    with jax.set_mesh(mesh):
        jp = jax.device_put(jax.tree.map(jnp.asarray, params),
                            model.param_shardings())
        trainer = jax_step.Trainer(model)

        def batch_of(tokens):
            tokens = jnp.asarray(tokens, jnp.int32)
            return trainer.shard_batch(
                {'tokens': tokens, 'targets': jnp.roll(tokens, -1, 1)})

        first = batch_of(token_batches[0])

        def loss_fn(p, batch):
            logits, aux = model.apply_with_aux(p, batch['tokens'])
            return (jax_step.cross_entropy_loss(logits, batch['targets'])
                    + model.aux_loss_weight * aux), (logits, aux)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (logits, aux)), grads = grad_fn(jp, first)
        ref['logits'], ref['aux'] = np.asarray(logits), float(aux)
        ref['loss'] = float(loss)
        ref['grads'] = flat(jax.tree.map(np.asarray, grads))
        state = jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                    opt_state=trainer.tx.init(jp))
        step = trainer.step_fn()
        ref['metrics'], ref['step_grads'] = [], []
        for tokens in token_batches:
            batch = batch_of(tokens)
            if step_grads:
                ref['step_grads'].append(flat(jax.tree.map(
                    np.asarray, grad_fn(state.params, batch)[1])))
            state, m = step(state, batch)
            ref['metrics'].append((float(m['loss']), float(m['grad_norm'])))
        ref['params'] = flat(jax.tree.map(np.asarray, state.params))
    return ref


# -- the parent's checks of one mesh ------------------------------------------
def check_logits(sizes, ref, ranks):
    """The ranks' logits, placed at their global rows (``Trainer
    .row_index``: microbatch-major under pp), against JAX's."""
    got = assemble(ranks, 'logits', sizes,
                   [('dp', 'fsdp'), ('sp',), ('tp',)])
    batch = [a for a in ('dp', 'fsdp') if sizes.get(a, 1) > 1]
    by_place = {}
    for r in ranks:
        i = 0
        for a in batch:
            i = i * sizes[a] + r['coords'][a]
        by_place[i] = r['rows'].numpy()
    rows = np.concatenate([by_place[i] for i in sorted(by_place)])
    full = np.empty_like(got)
    full[rows] = got
    close(full, ref['logits'], tol=1e-5)


def check_grads(ref, ranks):
    for r in ranks:
        close(r['loss'], ref['loss'], tol=1e-5)
        for name, want in ref['grads'].items():
            close(r['grads'][name], want, tol=1e-5)


# AdamW's update is lr * m / (sqrt(v) + eps) with eps 1e-8: where an
# element's gradient is within a few eps of 0 (a sum that cancels), the
# f32 summation order moves its update by a good part of lr, and the
# reference itself differs that much between two layouts of the same
# arithmetic (``tests/test_torch_ep.py``). ``check_steps(eps_aware=True)``
# holds those elements, and only those, to the steps' reach instead.
ADAM_EPS_REGIME = 1e-7
ADAM_REACH = 3e-4 * STEPS


def check_steps(ref, ranks, eps_aware=False):
    for r in ranks:
        for (loss, norm), (jloss, jnorm) in zip(r['metrics'],
                                                ref['metrics']):
            close(loss, jloss, tol=1e-5)
            close(norm, jnorm, tol=1e-5)
    for name, want in ref['params'].items():
        got = np.asarray(ranks[0]['full'][name])
        if eps_aware:
            at_eps = np.min([np.abs(g[name]) for g in ref['step_grads']],
                            axis=0) < ADAM_EPS_REGIME
            assert np.all(np.abs(got - want)[at_eps] <= ADAM_REACH), name
            got = np.where(at_eps, want, got)
        close(got, want)


def check_one_device(one, ranks):
    _, losses, params = one
    for r in ranks:
        close(r['seed_losses'], losses, tol=1e-5)
    for name, want in params.items():
        close(ranks[0]['seed_full'][name], want)


def check_replicated_identical(ranks):
    """Ranks that hold the same slice of a leaf (equal coordinates on
    the axes that split it) hold the same bits after the steps."""
    from skypilot_tpu_torch.parallel.sharding import spec_axes
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
