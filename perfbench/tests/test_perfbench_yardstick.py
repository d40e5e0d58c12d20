"""The benchmark's counts against hand-worked values."""
import pytest

from perfbench import registry, yardstick


def _dims(name):
    return yardstick.model_dims(registry.config(name))


def test_mistral_parameter_count():
    d = _dims('mistral-7b')
    per_layer = yardstick.layer_matmul_params(d)
    # q 4096x4096, k and v 4096x1024, o 4096x4096, SwiGLU 3 x 4096x14336
    assert per_layer == 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    total = per_layer * 32 + 2 * 32768 * 4096 + 32 * 2 * 4096 + 4096
    assert total == pytest.approx(7.248e9, rel=1e-3)


def test_mixtral_active_parameters():
    d = _dims('mixtral-8x7b')
    per_layer = yardstick.layer_matmul_params(d)
    assert per_layer == (4096 * 4096 * 2 + 4096 * 1024 * 2
                         + 2 * 3 * 4096 * 14336 + 4096 * 8)


def test_visible_pairs():
    assert yardstick.visible_pairs(4, 4, True) == 10
    assert yardstick.visible_pairs(1, 7, True) == 7
    assert yardstick.visible_pairs(2, 5, True) == 4 + 5
    assert yardstick.visible_pairs(3, 5, False) == 15


def test_prefill_and_decode_flops():
    d = _dims('mistral-7b')
    p = yardstick.layer_matmul_params(d)
    t = 1000
    want = (2 * t * p * 32 + 32 * 4 * 32 * 128 * t * (t + 1) / 2
            + 2 * 4096 * 32768)
    assert yardstick.prefill_flops(d, t) == pytest.approx(want)
    want = 2 * p * 32 + 32 * 4 * 32 * 128 * 1001 + 2 * 4096 * 32768
    assert yardstick.decode_token_flops(d, 1000) == pytest.approx(want)


def test_train_step_flops():
    d = dict(_dims('mistral-7b'), layers=8)
    p = yardstick.layer_matmul_params(d)
    b, t = 2, 8192
    fwd = 2 * b * t * (8 * p + 4096 * 32768) + b * 8 * 4 * 32 * 128 * (
        t * (t + 1) // 2)
    assert yardstick.train_step_flops(d, b, t) == pytest.approx(3 * fwd)
    # ~6 N per token with N = 1.88 B multiplied parameters, plus attention
    assert yardstick.train_step_flops(d, b, t) == pytest.approx(2.1e14,
                                                                rel=0.05)


def test_flash_bounds():
    # b 1 x 8192^2, 16/8 heads of 128: operations bound 0.2780 ms, as the
    # port's kernel phase prints it
    s = yardstick.flash_fwd_bound_s(1, 8192, 8192, 16, 8, 128)
    assert s * 1e3 == pytest.approx(0.2780, rel=1e-3)
    s = yardstick.flash_bwd_bound_s(1, 8192, 8192, 16, 8, 128)
    assert s * 1e3 == pytest.approx(0.6949, rel=1e-3)
    # 512^2 is bound by bytes: 4 MiB of q, k, v, out and lse
    b = 1 * (2.0 * 128 * (2 * 512 * 16 + 2 * 512 * 8) + 4.0 * 16 * 512)
    s = yardstick.flash_fwd_bound_s(1, 512, 512, 16, 8, 128)
    assert s == pytest.approx(b / yardstick.PEAK_HBM_BYTES_S)
