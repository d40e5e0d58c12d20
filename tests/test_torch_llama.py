"""The PyTorch port's LlamaModel against the JAX package's, test-tiny.

The JAX parameters (``jax.random.key(0)``) are carried into the port as
numpy arrays with ``params_from_numpy``, so both sides compute the same
function. f32 everywhere: logits agree to 1e-4 (f32 round-off summed over
two layers and a 256-way head, in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.models import llama as torch_llama

TOL = 1e-4


@pytest.fixture(scope='module')
def models():
    jm = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'])
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = torch_llama.LlamaModel(torch_llama.PRESETS['test-tiny'],
                                device='cpu')
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def test_params_carry_over_by_name(models):
    _, jp, tm, tp = models
    flat_j = {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {f'layers/{n}': t for n, t in tp['layers'].items()}
    flat_t.update({n: t for n, t in tp.items() if n != 'layers'})
    assert set(flat_j) == set(flat_t)
    for name, arr in flat_j.items():
        np.testing.assert_array_equal(flat_t[name].numpy(), arr,
                                      err_msg=name)
    # The module's own tree is the one returned.
    assert tm.params()['layers']['wq'] is tp['layers']['wq']


def test_apply_logits_match_jax(models):
    jm, jp, tm, tp = models
    tokens = np.random.default_rng(0).integers(0, 256, (2, 11))
    want = jm.apply(jp, jnp.asarray(tokens, jnp.int32))
    got = tm.apply(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_apply_attention_impls_agree(models):
    _, _, tm, tp = models
    tokens = torch.arange(1, 14)[None]
    ref = tm.apply(tp, tokens, force_impl='reference')
    blk = tm.apply(tp, tokens, force_impl='blockwise')
    np.testing.assert_allclose(ref.numpy(), blk.numpy(), rtol=TOL,
                               atol=TOL)


def test_decode_step_oracle_matches_jax(models):
    """Prefill (T = 5) then three T = 1 steps through the plain decode
    oracle: last-token logits and the cache contents agree."""
    jm, jp, tm, tp = models
    jc = jm.init_cache(1, 32)
    tc = tm.init_cache(1, 32)
    step = jax.jit(jm.decode_step)
    prompt = np.array([[5, 17, 200, 3, 42]])
    feeds = [prompt, np.array([[7]]), np.array([[99]]), np.array([[1]])]
    for feed in feeds:
        jl, jc = step(jp, jc, jnp.asarray(feed, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert tc['length'] == int(jc['length']) == 8
    np.testing.assert_allclose(tc['k'].numpy(), np.asarray(jc['k']),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize('preset', sorted(torch_llama.PRESETS))
def test_num_params_equal(preset):
    assert (torch_llama.PRESETS[preset].num_params
            == jax_llama.PRESETS[preset].num_params)


def test_llama3_8b_config_is_the_jax_one():
    t = torch_llama.PRESETS['llama3-8b']
    j = jax_llama.PRESETS['llama3-8b']
    for field in ('vocab_size', 'embed_dim', 'num_layers', 'num_heads',
                  'num_kv_heads', 'head_dim', 'mlp_dim', 'max_seq_len',
                  'rope_theta', 'norm_eps', 'tie_embeddings'):
        assert getattr(t, field) == getattr(j, field), field
    assert t.dtype == torch.bfloat16
    assert 8.0e9 < t.num_params < 8.1e9


def test_init_draws_the_jax_distributions():
    """``init(generator)``: dense weights N(0, 1/fan_in) in the config
    dtype, norms ones, reproducible from the generator's seed."""
    cfg = dataclasses.replace(torch_llama.PRESETS['test-tiny'],
                              dtype=torch.bfloat16)
    model = torch_llama.LlamaModel(cfg, device='cpu')
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    assert params['layers']['wq'].dtype == torch.bfloat16
    assert torch.all(params['layers']['attn_norm'] == 1)
    assert torch.all(params['final_norm'] == 1)
    e, m = cfg.embed_dim, cfg.mlp_dim
    for name, fan_in in (('wq', e), ('w_down', m)):
        std = params['layers'][name].float().std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.1, (name, std)
    assert abs(params['embed'].float().std().item() - 1.0) < 0.05
    again = torch_llama.LlamaModel(cfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    assert torch.equal(again['lm_head'], params['lm_head'])


def test_params_from_numpy_takes_bf16_arrays():
    """JAX bf16 params arrive as ml_dtypes bfloat16 numpy arrays; they
    carry over bit for bit."""
    jcfg = dataclasses.replace(jax_llama.PRESETS['test-tiny'],
                               dtype=jnp.bfloat16)
    jp = jax.jit(jax_llama.LlamaModel(jcfg).init)(jax.random.key(1))
    tcfg = dataclasses.replace(torch_llama.PRESETS['test-tiny'],
                               dtype=torch.bfloat16)
    tp = torch_llama.LlamaModel(tcfg, device='cpu').params_from_numpy(
        jax.tree.map(np.asarray, jp))
    got = tp['layers']['w_up'].view(torch.int16).numpy()
    want = np.asarray(jp['layers']['w_up']).view(np.int16)
    np.testing.assert_array_equal(got, want)


def test_params_from_numpy_rejects_mismatched_trees(models):
    _, jp, _, _ = models
    tm = torch_llama.LlamaModel(torch_llama.PRESETS['test-tiny'],
                                device='cpu')
    tree = jax.tree.map(np.asarray, jp)
    tree['layers']['wq'] = tree['layers']['wq'][:, :, :2]
    with pytest.raises(ValueError, match='layers.wq'):
        tm.params_from_numpy(tree)
    del tree['lm_head']
    with pytest.raises(ValueError, match='lm_head'):
        tm.params_from_numpy(tree)


def test_bf16_lm_head_matches_jax_f32_accumulation(monkeypatch):
    """The lm head of ``apply_with_aux`` with bf16 weights (test-tiny)
    against the JAX package's ``einsum(x, head,
    preferred_element_type=f32)`` (skypilot_tpu/models/llama.py:327) on
    the port's own final hidden state x: the logits, and the gradients of
    x and of the head for one f32 cotangent. The port upcasts both bf16
    operands to f32; products of bf16 values are exact in f32, so the
    logits differ only by the order of the f32 sums, and the bf16
    gradients by at most one bf16 rounding (measured: logits within
    4.8e-7, gradients bit for bit)."""
    cfg = dataclasses.replace(torch_llama.PRESETS['test-tiny'],
                              dtype=torch.bfloat16)
    tm = torch_llama.LlamaModel(cfg, device='cpu')
    params = tm.init(torch.Generator().manual_seed(0))
    head = params['lm_head'].requires_grad_()
    params['final_norm'].requires_grad_()  # so that x takes a gradient
    normed = []
    real_norm = torch_llama.rms_norm

    def keep_output(*args, **kwargs):
        normed.append(real_norm(*args, **kwargs))
        return normed[-1]

    monkeypatch.setattr(torch_llama, 'rms_norm', keep_output)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 9))
    logits, _ = tm.apply_with_aux(params, torch.from_numpy(tokens))
    x = normed[-1]  # the final norm's output feeds the head
    x.retain_grad()
    cot = np.random.default_rng(1).standard_normal(
        tuple(logits.shape)).astype(np.float32)
    logits.backward(torch.from_numpy(cot))

    def jax_head(xj, hj):
        return jnp.einsum('bse,ev->bsv', xj, hj,
                          preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(jax_head,
                        jnp.asarray(x.detach().float().numpy(), jnp.bfloat16),
                        jnp.asarray(head.detach().float().numpy(),
                                    jnp.bfloat16))
    want_dx, want_dhead = vjp(jnp.asarray(cot))
    assert logits.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for got, ref in ((x.grad, want_dx), (head.grad, want_dhead)):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                                   atol=1e-6)
