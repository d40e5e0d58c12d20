"""Sequence parallelism in the port on the CPU (gloo), held against the
JAX package on the same mesh.

One spawn of 4 ranks runs every check, one process group, a mesh made
anew for each; meanwhile the parent computes the JAX references on XLA's
8 virtual CPU devices:

- ``ppermute`` on {sp: 4}, forward and backward;
- ``ring_attention`` against JAX's ``ring_attention`` under
  ``shard_map`` (KV repeated, as JAX needs it; the port reads GQA in
  place), forward and q/k/v gradients, causal and full, over sp 2 (the
  {dp: 2, sp: 2} mesh) and sp 4, in f32 (1e-5) and bf16 (1e-2 relative
  RMS per 64-row tile, ``utils/compare.py``, the kernels' bf16 measure:
  each side rounds P and each result to bf16 in its own order);
- one K1 and one K2 per visited ring block under remat 'dots';
- the global rotary positions of a sequence block;
- Llama on {sp: 2, fsdp: 2} and {sp: 2, tp: 2}: logits and gradients
  against JAX on the same mesh (1e-5), 3 trainer steps against the JAX
  ``Trainer`` there (losses and grad norms 1e-5, params 2e-5), leaves
  replicated over an axis identical on every rank holding them, and 3
  steps from the port's own init against its one-device run;
- ``train.run --sp 2`` inside the caller's group against one device.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_mesh_helpers as h

LLAMA_MESHES = {'sp2_fsdp2': {'sp': 2, 'fsdp': 2},
                'sp2_tp2': {'sp': 2, 'tp': 2}}
# (name, mesh, causal, hq, hkv, dtype)
RING_CASES = [(f'{kind}-sp{n}', {'sp': 4} if n == 4 else {'dp': 2, 'sp': 2},
               kind == 'causal', 4, 4, 'float32')
              for kind in ('causal', 'full') for n in (2, 4)] + [
    ('gqa-sp4', {'sp': 4}, True, 4, 2, 'float32'),
    ('bf16-sp4', {'sp': 4}, True, 4, 2, 'bfloat16')]
B, S, D = 2, 32, 16
RUN_ARGV = ['--preset', 'test-tiny', '--device', 'cpu', '--batch',
            str(h.BATCH), '--seq', str(h.SEQ), '--steps', '2',
            '--log-every', '1']


def _ring_inputs():
    rng = np.random.default_rng(7)
    return {name: tuple(rng.standard_normal(shape).astype(np.float32)
                        for shape in ((B, S, hq, D), (B, S, hkv, D),
                                      (B, S, hkv, D), (B, S, hq, D)))
            for name, _, _, hq, hkv, _ in RING_CASES}


# -- the ranks ----------------------------------------------------------------
def _rank_main(rank, port, inputs, out_dir):
    h.init_rank(rank, port)
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    out = {'ring': {}}
    for name, sizes, causal, _, _, dtype in RING_CASES:
        out['ring'][name] = _ring_case(make_mesh(MeshSpec(**sizes), 'cpu'),
                                       inputs['ring'][name], causal, dtype)
    mesh = make_mesh(MeshSpec(sp=4), 'cpu')
    out['ppermute'] = _ppermute_case(mesh)
    out['launches'] = _launch_case(inputs)
    out['positions'] = _positions_case(inputs)
    for name, sizes in LLAMA_MESHES.items():
        out[name] = h.llama_mesh_checks(sizes, inputs)
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    res = run.main(RUN_ARGV + ['--sp', '2', '--fsdp', '2'],
                   batch_fn=lambda step: tokens)
    out['run_main'] = [r['loss'] for r in res['log']]
    torch.save(out, f'{out_dir}/rank{rank}.pt')
    from skypilot_tpu_torch.runtime import distributed
    distributed.shutdown()


def _ring_case(mesh, arrays, causal, dtype):
    """This rank's block of out, dq, dk, dv for sum(out * dout)."""
    from skypilot_tpu_torch.parallel.ring_attention import ring_attention
    n, i = mesh.size('sp'), mesh.index('sp')
    blk = S // n
    q, k, v, dout = (torch.from_numpy(a[:, i * blk:(i + 1) * blk]).to(
        getattr(torch, dtype)) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ring_attention(q, k, v, mesh, 'sp', causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    return {'coords': mesh.coords, 'out': out.detach(),
            **dict(zip(('dq', 'dk', 'dv'), grads))}


def _ppermute_case(mesh):
    from skypilot_tpu_torch.parallel.sharding import ppermute
    i = mesh.index('sp')
    x = torch.full((3,), float(i), requires_grad=True)
    y = ppermute(x, mesh, 'sp', shift=1)
    w = torch.arange(3.0) + 10 * i
    (g,) = torch.autograd.grad((y * w).sum(), x)
    return {'index': i, 'y': y.detach(), 'grad': g}


def _launch_case(inputs):
    """K1 and K2 calls (their plain versions, on the CPU) of one forward
    and backward of test-tiny under remat 'dots' on {sp: 4}."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    from skypilot_tpu_torch.train.step import Trainer
    mesh = make_mesh(MeshSpec(sp=4), 'cpu')
    cfg = dataclasses.replace(PRESETS['test-tiny'], remat=True,
                              remat_policy='dots')
    trainer = Trainer(LlamaModel(cfg, device='cpu', mesh=mesh))
    state = trainer.state_from_params(
        trainer.model.params_from_numpy(inputs['params']))
    tokens = torch.from_numpy(inputs['batches'][0])
    batch = trainer.shard_batch({'tokens': tokens,
                                 'targets': torch.roll(tokens, -1, 1)})
    calls = {'fwd': 0, 'bwd': 0}
    saved = (attention.flash_attention_fwd_reference,
             attention.flash_attention_bwd_reference)

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper
    attention.flash_attention_fwd_reference = counted('fwd', saved[0])
    attention.flash_attention_bwd_reference = counted('bwd', saved[1])
    try:
        trainer.grads(state.params, batch)
    finally:
        (attention.flash_attention_fwd_reference,
         attention.flash_attention_bwd_reference) = saved
    return {'index': mesh.index('sp'), 'layers': cfg.num_layers, **calls}


def _positions_case(inputs):
    """Logits of this rank's block on {sp: 2, dp: 2} by default, with
    its global positions given, and with local ones."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(dp=2, sp=2), 'cpu')
    model = LlamaModel(PRESETS['test-tiny'], device='cpu', mesh=mesh)
    params = model.params_from_numpy(inputs['params'])
    blk = h.SEQ // 2
    i = mesh.index('sp')
    tokens = torch.from_numpy(inputs['batches'][0])[
        mesh.index('dp') * 2:(mesh.index('dp') + 1) * 2,
        i * blk:(i + 1) * blk]
    return {'index': i,
            'default': model.apply(params, tokens),
            'global': model.apply(params, tokens,
                                  i * blk + torch.arange(blk)),
            'local': model.apply(params, tokens, torch.arange(blk))}


# -- the references -----------------------------------------------------------
def _jax_ring(arrays, sizes, causal, dtype):
    """JAX's ring attention on an sp mesh of the case's size (KV
    repeated to the query heads first, as the JAX model does): out and
    the q/k/v gradients of sum(out * dout), whole."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from skypilot_tpu.parallel.ring_attention import ring_attention
    from skypilot_tpu.parallel.sharding import shard_map
    n = sizes['sp']
    mesh = Mesh(np.array(jax.devices()[:n]), ('sp',))
    spec = P(None, 'sp')
    kwargs = dict(mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    body = functools.partial(ring_attention, axis_name='sp', causal=causal)
    try:
        ring = shard_map(body, check_rep=False, **kwargs)
    except TypeError:
        ring = shard_map(body, check_vma=False, **kwargs)
    q, k, v, dout = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    rep = q.shape[2] // k.shape[2]

    def f(q, k, v):
        return ring(q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2))
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    grads = vjp(dout)
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the ranks' results, the JAX references, the port's one-device
    run, one-device ``train.run`` losses)."""
    params = h.jax_tiny_params()
    vocab = params['embed'].shape[0]
    inputs = {'params': params, 'batches': h.batches(vocab),
              'ring': _ring_inputs()}
    out_dir = str(tmp_path_factory.mktemp('ring'))
    ctx = h.spawn(_rank_main, (h.free_port(), inputs, out_dir))
    refs = {name: _jax_ring(inputs['ring'][name], sizes, causal, dtype)
            for name, sizes, causal, _, _, dtype in RING_CASES}
    refs.update({name: h.jax_llama_reference(sizes, params,
                                             inputs['batches'])
                 for name, sizes in LLAMA_MESHES.items()})
    one = h.one_device_run(vocab)
    from skypilot_tpu_torch.train import run
    tokens = torch.from_numpy(inputs['batches'][0])
    one_run = [r['loss'] for r in run.main(
        RUN_ARGV, batch_fn=lambda step: tokens)['log']]
    h.join(ctx)
    return h.load_ranks(out_dir), refs, one, one_run


def test_ring_attention_without_a_ring_is_flash_attention():
    """No mesh, or an sp axis of size 1: the one-device flash attention
    (JAX's ring degrades to local attention the same way)."""
    from skypilot_tpu_torch.ops.attention import flash_attention
    from skypilot_tpu_torch.parallel import Mesh, MeshSpec
    from skypilot_tpu_torch.parallel.ring_attention import ring_attention
    q, k, v, _ = (torch.from_numpy(a) for a in _ring_inputs()['gqa-sp4'])
    want = flash_attention(q, k, v, causal=True)
    assert torch.equal(ring_attention(q, k, v, None), want)
    assert torch.equal(ring_attention(q, k, v, Mesh(MeshSpec(tp=2))), want)


@pytest.mark.parametrize('case', [c[0] for c in RING_CASES[:4]])
def test_ring_attention_matches_jax(runs, case):
    _check_ring(runs, case, 1e-5)


def test_ring_attention_reads_gqa_in_place(runs):
    """hq 4, hkv 2: the port's KV stays at 2 heads (its dk/dv too);
    JAX repeats it and sums the gradient back through the repeat."""
    ranks = runs[0]
    assert ranks[0]['ring']['gqa-sp4']['dk'].shape[2] == 2
    _check_ring(runs, 'gqa-sp4', 1e-5)


def test_ring_attention_bf16(runs):
    from skypilot_tpu_torch.utils.compare import TILE_RTOL, tile_rel_err
    ranks = runs[0]
    assert ranks[0]['ring']['bf16-sp4']['out'].dtype == torch.bfloat16
    assert TILE_RTOL == 1e-2
    _check_ring(runs, 'bf16-sp4', lambda got, want: tile_rel_err(
        torch.tensor(got), torch.tensor(want)) <= TILE_RTOL)


def _check_ring(runs, case, tol):
    """The case's out, dq, dk, dv from every rank's block against JAX's:
    within ``tol`` elementwise, or ``tol(got, want)`` holds."""
    ranks, refs = runs[0], runs[1]
    sizes = dict(next(c[1] for c in RING_CASES if c[0] == case))
    recs = [dict(r['ring'][case]) for r in ranks]
    for key, want in zip(('out', 'dq', 'dk', 'dv'), refs[case]):
        for rec in recs:
            rec[f'{key}32'] = rec[key].float()
        got = h.assemble(recs, f'{key}32', sizes, [('dp',), ('sp',)])
        if 'dp' in sizes:  # both dp rows ran the same sequences
            got = got[:B]
        if callable(tol):
            assert tol(got, want), key
        else:
            h.close(got, want, tol)


def test_ppermute_and_its_backward(runs):
    """Rank i receives rank i - 1's tensor; x's gradient is the weight
    of the rank it went to."""
    for r in runs[0]:
        rec = r['ppermute']
        i = rec['index']
        assert rec['y'].tolist() == [float((i - 1) % 4)] * 3
        assert rec['grad'].tolist() == (torch.arange(3.0)
                                        + 10 * ((i + 1) % 4)).tolist()


def test_ring_runs_k1_and_k2_once_per_visited_block(runs):
    """Under 'dots' rank i of sp 4 attends i + 1 blocks per layer: one K1
    each (the recompute keeps K1's outputs) and one K2 each."""
    for r in runs[0]:
        rec = r['launches']
        want = rec['layers'] * (rec['index'] + 1)
        assert (rec['fwd'], rec['bwd']) == (want, want)


def test_sequence_block_rotary_positions_are_global(runs):
    for r in runs[0]:
        rec = r['positions']
        assert torch.equal(rec['default'], rec['global'])
        if rec['index']:
            assert not torch.allclose(rec['default'], rec['local'])


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


def test_sp_run_matches_the_one_device_run(mesh_run):
    _, _, ranks, one = mesh_run
    h.check_one_device(one, ranks)


def test_run_main_sp2_matches_one_device(runs):
    ranks, _, _, one_run = runs
    assert len(one_run) == 2
    for r in ranks:
        h.close(r['run_main'], one_run, tol=1e-5)
