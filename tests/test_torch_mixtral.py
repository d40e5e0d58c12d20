"""The port's Mixtral (sparse MoE) against the JAX package's, on the CPU.

test-tiny-moe in f32: the JAX weights (``jax.random.key(0)``) carried into
the port with ``params_from_numpy``, the router kept in f32. The forward's
logits agree within 1e-4 and its aux loss (the mean over layers of each
layer's load-balance loss) within 1e-6; three trainer steps reach the JAX
parameters within 2e-5; the decode engine's greedy streams equal the naive
oracle's and the JAX engine's, for every KV layout. The preset's capacity
factor (4.0) drops nothing; the cases at 0.5 drop, so routing depends on
which tokens share a dispatch, and the port must feed the MoE the rows the
JAX engine feeds it.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import mixtral as jax_mixtral
from skypilot_tpu.train import step as jax_step
from skypilot_tpu_torch.models import decode as torch_decode
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.models import mixtral as torch_mixtral
from skypilot_tpu_torch.train import checkpoint as torch_checkpoint
from skypilot_tpu_torch.train import run as torch_run
from skypilot_tpu_torch.train import step as torch_step

TOL = 1e-4
STEP_TOL = 2e-5
JCFG = jax_mixtral.PRESETS['test-tiny-moe']
TCFG = torch_mixtral.PRESETS['test-tiny-moe']
MODES = {
    'paged': dict(kv_block=16),
    'contiguous': dict(kv_block=0),
    'int8': dict(kv_block=16, kv_dtype='int8'),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def weights():
    jp = jax.jit(jax_mixtral.MixtralModel(JCFG).init)(jax.random.key(0))
    return jax.tree.map(np.asarray, jp)


def _models(np_params, cf=None):
    """(JAX model, JAX params, port model, port params) at the preset's
    capacity factor or at ``cf``."""
    jcfg = JCFG if cf is None else dataclasses.replace(JCFG,
                                                       capacity_factor=cf)
    tcfg = TCFG if cf is None else dataclasses.replace(TCFG,
                                                       capacity_factor=cf)
    tm = torch_mixtral.MixtralModel(tcfg, device='cpu')
    return (jax_mixtral.MixtralModel(jcfg),
            jax.tree.map(jnp.asarray, np_params), tm,
            tm.params_from_numpy(np_params))


def test_params_carry_over_with_an_f32_router(weights):
    _, _, tm, tp = _models(weights)
    assert set(tp['layers']) == set(weights['layers'])
    assert 'w_gate' not in tp['layers']
    for name, want in weights['layers'].items():
        got = tp['layers'][name]
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want)
    assert tp['layers']['router'].dtype == torch.float32
    bf16 = torch_mixtral.MixtralModel(torch_mixtral.PRESETS['mixtral-8x7b'],
                                      device='meta')
    assert bf16.layers['router'].dtype == torch.float32
    assert bf16.layers['we_gate'].dtype == torch.bfloat16


@pytest.mark.parametrize('cf', [None, 0.5])
def test_apply_logits_and_aux_match_jax(weights, cf):
    jm, jp, tm, tp = _models(weights, cf)
    tokens = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 24))
    want, want_aux = jm.apply_with_aux(jp, jnp.asarray(tokens))
    got = tm.apply(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    logits, aux = tm.apply_with_aux(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert float(aux) > 0.0


@pytest.mark.parametrize('preset', sorted(torch_mixtral.PRESETS))
def test_param_counts_match_jax(preset):
    want = jax_mixtral.PRESETS[preset]
    got = torch_mixtral.PRESETS[preset]
    assert got.num_params == want.num_params
    assert got.active_params == want.active_params
    assert got.flops_params == got.active_params < got.num_params
    assert (got.train_flops_per_token(4096)
            == want.train_flops_per_token(4096))
    tm = torch_mixtral.MixtralModel(got, device='meta')
    assert sum(p.numel() for p in tm.parameters()) == got.num_params


# (case, remat policy, capacity factor): the preset drops nothing; at
# 1.25 the 4 x 32 tokens of a batch overflow some experts.
TRAIN_CASES = [('full', 'full', None), ('dots', 'dots', None),
               ('names', 'names', None), ('drops', 'full', 1.25)]


@pytest.mark.parametrize('case,policy,cf', TRAIN_CASES)
def test_three_trainer_steps_match_jax(weights, case, policy, cf):
    jm, jp, tm, _ = _models(weights, cf)
    jm = jax_mixtral.MixtralModel(dataclasses.replace(
        jm.config, remat=True, remat_policy=policy))
    tm = torch_mixtral.MixtralModel(dataclasses.replace(
        tm.config, remat=True, remat_policy=policy), device='cpu')
    jtr = jax_step.Trainer(jm)
    jstate = jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                 opt_state=jtr.tx.init(jp))
    ttr = torch_step.Trainer(tm)
    tstate = ttr.state_from_params(tm.params_from_numpy(weights))
    assert tm.aux_loss_weight == 0.02
    jstep, tstep = jtr.step_fn(), ttr.step_fn()
    rng = np.random.default_rng(11)
    for i in range(3):
        tokens = rng.integers(0, JCFG.vocab_size, (4, 32))
        targets = np.roll(tokens, -1, axis=1)
        jstate, jmet = jstep(jstate, {
            'tokens': jnp.asarray(tokens, jnp.int32),
            'targets': jnp.asarray(targets, jnp.int32)})
        tstate, tmet = tstep(tstate, {'tokens': torch.from_numpy(tokens),
                                      'targets': torch.from_numpy(targets)})
        np.testing.assert_allclose(float(tmet['loss']), float(jmet['loss']),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_allclose(float(tmet['grad_norm']),
                                   float(jmet['grad_norm']), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    for name in torch_step.leaf_names(tstate.params):
        np.testing.assert_allclose(
            torch_step.get_leaf(tstate.params, name).detach().numpy(),
            np.asarray(torch_step.get_leaf(jstate.params, name)),
            rtol=STEP_TOL, atol=STEP_TOL, err_msg=name)
    assert torch_step.get_leaf(tstate.params,
                               'layers/router').dtype == torch.float32


def test_warm_cache_key_tells_mixtral_from_llama():
    llama_cfg = torch_llama.PRESETS['test-tiny']
    moe_cfg = torch_mixtral.MixtralConfig(**{
        f.name: getattr(llama_cfg, f.name)
        for f in dataclasses.fields(llama_cfg)})
    keys = {torch_step.Trainer(torch_llama.LlamaModel(llama_cfg,
                                                      device='cpu'))
            .warm_cache_key(),
            torch_step.Trainer(torch_mixtral.MixtralModel(moe_cfg,
                                                          device='cpu'))
            .warm_cache_key(),
            torch_step.Trainer(torch_mixtral.MixtralModel(
                dataclasses.replace(moe_cfg, top_k=1), device='cpu'))
            .warm_cache_key()}
    assert len(keys) == 3


class Side:
    """One engine (JAX or port) over the Mixtral weights, driven through
    the same calls."""

    def __init__(self, models, is_jax, batch_slots=2, max_len=64, **mode):
        jm, jp, tm, tp = models
        self.is_jax = is_jax
        if is_jax:
            self.eng = jax_decode.DecodeEngine(
                jm.config, batch_slots=batch_slots, max_len=max_len,
                model=jm, **mode)
            self.params, self.rng = jp, jax.random.key(0)
        else:
            self.eng = torch_decode.DecodeEngine(
                tm.config, batch_slots=batch_slots, max_len=max_len,
                model=tm, device='cpu', **mode)
            self.params = tp
            self.rng = torch.Generator().manual_seed(0)
        self.state = self.eng.init_state()

    def tokens(self, toks):
        return jnp.asarray(toks, jnp.int32) if self.is_jax else toks

    def admit(self, prompt, slot, bucket=16):
        self.state, first, self.rng = self.eng.admit(
            self.params, self.state, self.tokens(_padded(prompt, bucket)),
            len(prompt), slot, self.rng)
        return int(first)

    def admit_many(self, prompts, slots, bucket=16):
        n = len(prompts)
        self.state, firsts, self.rng = self.eng.admit_many(
            self.params, self.state,
            self.tokens([_padded(p, bucket) for p in prompts]),
            [len(p) for p in prompts], slots, self.rng, [0.0] * n, [0] * n)
        return [int(t) for t in firsts]

    def chunk(self, prompt, chunk, slot):
        for off, cb, final in jax_decode.chunk_spans(len(prompt), chunk,
                                                     self.eng.max_len):
            piece = self.tokens(_padded(prompt[off:off + cb], cb))
            if final:
                self.state, first, self.rng = self.eng.prefill_chunk_final(
                    self.params, self.state, piece, off, slot, len(prompt),
                    self.rng)
            else:
                self.state = self.eng.prefill_chunk(self.params, self.state,
                                                    piece, off, slot)
        return int(first)

    def step(self):
        self.state, sampled, self.rng = self.eng.step(self.params,
                                                      self.state, self.rng)
        return [int(t) for t in sampled]

    def verify(self, draft):
        self.state, out, acc, self.rng = self.eng.step_verify(
            self.params, self.state, self.rng, self.tokens(draft))
        return np.asarray(out).tolist(), [int(a) for a in acc]


def _padded(prompt, bucket):
    return list(prompt) + [0] * (bucket - len(prompt))


_ORACLE = {}


def naive_greedy(tm, tp, prompt, n):
    """Recompute the port's full forward per generated token."""
    key = (tm.config.capacity_factor, tuple(prompt))
    toks = list(_ORACLE.get(key, ()))
    while len(toks) < n:
        logits = tm.apply(tp, torch.tensor([list(prompt) + toks]))
        toks.append(int(logits[0, -1].argmax()))
    _ORACLE[key] = toks
    return toks[:n]


@pytest.mark.parametrize('mode', sorted(MODES))
def test_engine_greedy_matches_oracle_and_jax(weights, mode):
    """The port of tests/test_decode.py::test_moe_engine_matches_naive_
    greedy, for each KV layout: prefill + insert, then plain steps."""
    models = _models(weights)
    prompt = [1, 9, 77, 123]
    streams = []
    for is_jax in (True, False):
        side = Side(models, is_jax, **MODES[mode])
        k, v, logits = side.eng.prefill(side.params,
                                        side.tokens(_padded(prompt, 16)),
                                        len(prompt))
        first = int(np.argmax(np.asarray(logits)))
        side.state = side.eng.insert(side.state, k, v, len(prompt), first,
                                     0)
        streams.append([first] + [side.step()[0] for _ in range(5)])
    assert streams[1] == streams[0]
    assert streams[1] == naive_greedy(models[2], models[3], prompt, 6)


@pytest.mark.parametrize('cf', [None, 0.5])
def test_admit_many_matches_jax(weights, cf):
    """One admit_many routes the prompts' padded rows together: at 0.5 the
    result is not that of solo admits, and still the JAX engine's."""
    models = _models(weights, cf)
    prompts = [[5, 17, 200, 3], [99, 7, 7, 1, 64, 2, 8], [42] * 11]
    js, ts = Side(models, True, batch_slots=4), Side(models, False,
                                                     batch_slots=4)
    slots = [2, 0, 1]
    assert ts.admit_many(prompts, slots) == js.admit_many(prompts, slots)
    for name in ('lengths', 'active', 'last_tokens'):
        np.testing.assert_array_equal(getattr(ts.state, name).numpy(),
                                      np.asarray(getattr(js.state, name)))
    np.testing.assert_allclose(ts.state.k.numpy(), np.asarray(js.state.k),
                               rtol=TOL, atol=TOL)
    for _ in range(4):
        assert ts.step()[:3] == js.step()[:3]


def test_streams_match_jax_when_routing_drops(weights):
    """Capacity factor 0.5: admits, a chunked prefill, plain steps and
    verify steps (N = 2 x 5 rows, capacity 8, drops possible) emit the
    JAX engine's tokens."""
    models = _models(weights, 0.5)
    p0, p1 = [4, 8, 15, 16, 23, 42], list(range(30, 70))
    out = []
    for is_jax in (True, False):
        side = Side(models, is_jax, spec_tokens=4, **MODES['paged'])
        toks = [[side.admit(p0, 0)], [side.chunk(p1, 16, 1)]]
        for _ in range(2):
            for s, t in enumerate(side.step()):
                toks[s].append(t)
        for _ in range(3):
            draft = [torch_decode.draft_tokens(p + o, 4)
                     for p, o in zip((p0, p1), toks)]
            emitted, acc = side.verify(draft)
            for s in (0, 1):
                toks[s].extend(emitted[s][:acc[s] + 1])
        out.append(toks)
    assert out[1] == out[0]


def test_cost_model_and_ledger_match_jax(weights):
    """The analytic cost model counts one dense MLP of FLOPs and every
    expert's bytes, as the JAX formula does."""
    jm, jp, tm, tp = models = _models(weights)
    js, ts = Side(models, True), Side(models, False)
    for kind, shape in (('step', (2,)), ('step_verify', (2, 4)),
                        ('prefill', (32,)), ('prefill_chunk', (16,))):
        assert (ts.eng.estimate_step_cost(kind, *shape)
                == js.eng.estimate_step_cost(kind, *shape))
    assert ts.eng.hbm_ledger(ts.state, tp) == js.eng.hbm_ledger(js.state,
                                                                 jp)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_train_checkpoint_resume_and_serve_over_the_cli(tmp_path, capsys):
    """The port of tests/test_decode.py::test_generation_server_main_
    mixtral_and_ckpt: train 2 steps of tiny Mixtral with checkpoints,
    resume for a third, then serve the checkpoint from the replica's CLI
    and generate."""
    ckpt = str(tmp_path / 'ck')
    argv = ['--model', 'mixtral', '--preset', 'test-tiny-moe', '--device',
            'cpu', '--batch', '8', '--seq', '32', '--ckpt-dir', ckpt,
            '--save-every', '1', '--log-every', '1']
    first = torch_run.main(argv + ['--steps', '2'])
    assert [r['step'] for r in first['log']] == [1, 2]
    again = torch_run.main(argv + ['--steps', '3'])
    assert again['start_step'] == 2 and '[train] resumed from step 2' in \
        capsys.readouterr().out
    tree = torch_checkpoint.CheckpointManager(ckpt).read(3)
    assert tree['params']['layers']['router'].dtype == torch.float32
    assert tree['opt_state']['nu']['layers']['router'].dtype == \
        torch.float32
    assert tree['opt_state']['count'] == 3

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.generation_server',
         '--model', 'mixtral', '--preset', 'test-tiny-moe', '--device',
         'cpu', '--port', str(port), '--batch-slots', '2', '--max-len',
         '64', '--ckpt-dir', ckpt],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f'server exited {proc.returncode}: '
                                     f'{proc.stdout.read()[-2000:]}')
            try:
                with urllib.request.urlopen(f'{base}/health',
                                            timeout=5) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                pass
            assert time.time() < deadline, 'server never became healthy'
            time.sleep(0.2)
        body = json.dumps({'tokens': [1, 9, 77], 'max_tokens': 4}).encode()
        req = urllib.request.Request(f'{base}/generate', data=body)
        with urllib.request.urlopen(req, timeout=60) as resp:
            result = json.loads(resp.read())
        assert result['num_tokens'] == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # The served tokens are the trained model's greedy continuation.
    model = torch_mixtral.MixtralModel(TCFG, device='cpu')
    params = model.params_from_numpy(tree['params'])
    seq = [1, 9, 77]
    for _ in range(4):
        seq.append(int(model.apply(params, torch.tensor([seq]))[0, -1]
                       .argmax()))
    assert result['tokens'] == seq[3:]
