"""The port's MoE routing and expert FFN against ``skypilot_tpu.ops.moe``,
on the CPU.

Inputs come from numpy seeds and go through both functions. Routing must
keep the same (token, expert, slot) assignments as the JAX dispatch
tensor, with the same dropped fraction bit for bit and the aux loss
within 1e-6. The FFN's output agrees within 1e-5 in f32 and 1e-2 relative
L2 in bf16. Its gradients (output and aux loss) agree within 1e-4
relative L2 in f32, with and without drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import moe as jax_moe
from skypilot_tpu_torch.ops import moe as torch_moe

D, M = 16, 32


@pytest.mark.parametrize('n,e,k,cf', [
    (1, 8, 2, 1.25), (8, 8, 2, 1.25), (40, 8, 2, 1.25), (64, 4, 2, 1.25),
    (100, 8, 2, 1.25), (4096, 8, 2, 1.25), (64, 8, 1, 0.25), (7, 3, 2, 1.0),
    (333, 8, 2, 4.0), (1000, 8, 2, 4.0)])
def test_expert_capacity_matches_jax(n, e, k, cf):
    got = torch_moe.expert_capacity(n, e, k, cf)
    assert got == jax_moe.expert_capacity(n, e, k, cf)
    assert got % 8 == 0 and got >= 8


def _dense(dest, weights, n, e, cap):
    """The JAX dispatch and combine tensors [N, E, C] rebuilt from the
    port's per-assignment slots and weights."""
    dispatch = np.zeros((n, e * cap + 1), np.float32)
    combine = np.zeros((n, e * cap + 1), np.float32)
    for k in range(dest.shape[0]):
        dispatch[np.arange(n), dest[k]] += 1.0
        combine[np.arange(n), dest[k]] += weights[k]
    return (dispatch[:, :e * cap].reshape(n, e, cap),
            combine[:, :e * cap].reshape(n, e, cap))


@pytest.mark.parametrize('k', [1, 2])
@pytest.mark.parametrize('e', [4, 8])
@pytest.mark.parametrize('cf', [8.0, 0.25, 0.5, 1.25])
def test_top_k_routing_matches_jax(cf, e, k):
    n = 64
    rng = np.random.default_rng(100 * e + 10 * k + int(cf * 4))
    logits = rng.standard_normal((n, e)).astype(np.float32) * 2
    cap = jax_moe.expert_capacity(n, e, k, cf)
    j_dispatch, j_combine, j_aux = jax_moe.top_k_routing(
        jnp.asarray(logits), k, cap)
    dest, weights, aux = torch_moe.top_k_routing(torch.from_numpy(logits), k,
                                                 cap)
    assert dest.shape == weights.shape == (k, n)
    dispatch, combine = _dense(dest.numpy(), weights.numpy(), n, e, cap)
    # The same kept (token, expert, slot) set, each slot held once.
    np.testing.assert_array_equal(dispatch, np.asarray(j_dispatch))
    np.testing.assert_allclose(combine, np.asarray(j_combine), rtol=1e-6,
                               atol=1e-6)
    assert float(aux['dropped_frac']) == float(j_aux['dropped_frac'])
    assert abs(float(aux['aux_loss']) - float(j_aux['aux_loss'])) <= 1e-6
    if cf == 8.0:
        assert float(aux['dropped_frac']) == 0.0
    if cf == 0.25:  # capacity 8 < the 16-32 tokens per expert
        assert float(aux['dropped_frac']) > 0.0


def test_all_equal_logits_route_to_experts_0_and_1():
    """Ties go to the lower expert index, as lax.top_k breaks them: every
    token's choices are experts 0 and 1, queued in token order."""
    n, e, cap = 12, 8, 16
    logits = np.zeros((n, e), np.float32)
    j_dispatch = np.asarray(jax_moe.top_k_routing(jnp.asarray(logits), 2,
                                                  cap)[0])
    dest, weights, aux = torch_moe.top_k_routing(torch.from_numpy(logits),
                                                 2, cap)
    assert dest[0].tolist() == list(range(n))
    assert dest[1].tolist() == [cap + i for i in range(n)]
    np.testing.assert_array_equal(weights.numpy(), np.full((2, n), 0.5))
    dispatch, _ = _dense(dest.numpy(), weights.numpy(), n, e, cap)
    np.testing.assert_array_equal(dispatch, j_dispatch)
    assert float(aux['dropped_frac']) == 0.0


def _ffn_inputs(seed, e, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    w_router = rng.standard_normal((D, e)).astype(np.float32) * D ** -0.5
    w_gate = rng.standard_normal((e, D, M)).astype(np.float32) * D ** -0.5
    w_up = rng.standard_normal((e, D, M)).astype(np.float32) * D ** -0.5
    w_down = rng.standard_normal((e, M, D)).astype(np.float32) * M ** -0.5
    return x, w_router, w_gate, w_up, w_down


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize('cf', [8.0, 0.5])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_moe_ffn_matches_jax(dtype, cf):
    x, w_router, w_gate, w_up, w_down = _ffn_inputs(3, 4)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jx(a, dt=jdt):
        return jnp.asarray(a).astype(dt)

    def tx(a, dt=tdt):
        return torch.from_numpy(a).to(dt)

    want, j_aux = jax_moe.moe_ffn(jx(x), jx(w_router, jnp.float32),
                                  jx(w_gate), jx(w_up), jx(w_down),
                                  top_k=2, capacity_factor=cf)
    got, aux = torch_moe.moe_ffn(tx(x), tx(w_router, torch.float32),
                                 tx(w_gate), tx(w_up), tx(w_down), top_k=2,
                                 capacity_factor=cf)
    assert got.dtype == tdt and got.shape == x.shape
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel_l2(got, want) <= 1e-2
    assert float(aux['dropped_frac']) == float(j_aux['dropped_frac'])
    assert (float(aux['dropped_frac']) > 0.0) == (cf == 0.5)


@pytest.mark.parametrize('cf', [8.0, 0.5])
@pytest.mark.parametrize('which', ['out', 'aux'])
def test_moe_ffn_grads_match_jax(which, cf):
    """d/d(x, router, w_gate, w_up, w_down) of <out, cotangent> or of the
    aux loss: the router's gradient flows through the gates (out) and the
    mean probabilities (aux), none through the slots."""
    inputs = _ffn_inputs(5, 4)
    cot = np.random.default_rng(6).standard_normal(inputs[0].shape).astype(
        np.float32)

    def jax_loss(*args):
        y, aux = jax_moe.moe_ffn(*args, top_k=2, capacity_factor=cf)
        return (jnp.sum(y * cot) if which == 'out' else aux['aux_loss'])

    want = jax.grad(jax_loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, aux = torch_moe.moe_ffn(*leaves, top_k=2, capacity_factor=cf)
    assert (float(aux['dropped_frac']) > 0.0) == (cf == 0.5)
    loss = ((y * torch.from_numpy(cot)).sum() if which == 'out'
            else aux['aux_loss'])
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, g, w in zip(('x', 'router', 'w_gate', 'w_up', 'w_down'), got,
                          want):
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        assert _rel_l2(g, w) <= 1e-4, name
        if which == 'aux' and name.startswith('w_'):
            assert not np.any(g)
