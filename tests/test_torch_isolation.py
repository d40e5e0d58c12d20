"""The PyTorch port stands alone: no JAX, nothing of ``skypilot_tpu``.

An AST scan of every module of ``skypilot_tpu_torch/`` and of
``chip_smoke.py``; a subprocess that imports every port module with JAX
made unimportable; and the entry points' refusal to run on the CPU
unless asked to.
"""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO_ROOT, 'skypilot_tpu_torch')
FORBIDDEN_ROOTS = ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                   'skypilot_tpu')


def _port_sources():
    paths = [os.path.join(REPO_ROOT, 'chip_smoke.py')]
    for root, _, files in os.walk(PORT_DIR):
        paths.extend(os.path.join(root, f) for f in files
                     if f.endswith('.py'))
    return sorted(paths)


def _port_modules():
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO_ROOT)
        if not rel.startswith('skypilot_tpu_torch'):
            continue
        mod = rel[:-3].replace(os.sep, '.')
        mods.append(mod[:-len('.__init__')] if mod.endswith('__init__')
                    else mod)
    return mods


def _imported_roots(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.lineno, node.module


def test_no_jax_or_jax_package_import_anywhere_in_the_port():
    offenders = []
    for path in _port_sources():
        for line, name in _imported_roots(path):
            if name.split('.')[0] in FORBIDDEN_ROOTS:
                offenders.append(f'{os.path.relpath(path, REPO_ROOT)}:'
                                 f'{line} imports {name}')
    assert not offenders, '\n'.join(offenders)
    assert len(_port_sources()) > 10  # the scan saw the package


def test_every_port_module_imports_without_jax():
    """Fresh interpreter, ``jax`` made unimportable: every port module
    imports, and no module of the JAX package gets loaded."""
    code = (
        'import sys, importlib\n'
        "sys.modules['jax'] = None\n"
        f'for m in {_port_modules()!r}:\n'
        '    importlib.import_module(m)\n'
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
        "None and (m == 'skypilot_tpu' or m.startswith('skypilot_tpu.') "
        "or m.split('.')[0] == 'jax'))\n"
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=REPO_ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda):
    from skypilot_tpu_torch.models.decode import DecodeEngine
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.serve import generation_server as gs
    cfg = PRESETS['test-tiny']
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DecodeEngine(cfg, batch_slots=2, max_len=64, kv_block=16)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LlamaModel(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        gs.GenerationScheduler(cfg, None, batch_slots=2, max_len=64,
                               kv_block=16)
    args = gs.build_parser().parse_args(['--preset', 'test-tiny'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        gs.build_scheduler(args)
    # Asked for explicitly, the CPU is fine.
    DecodeEngine(cfg, batch_slots=2, max_len=64, kv_block=16, device='cpu')


def test_trainer_refuses_to_fall_back_to_the_cpu(no_cuda):
    """``train.run`` and the trainer's model start on the card unless the
    CPU is asked for."""
    from skypilot_tpu_torch.models.llama import PRESETS, LlamaModel
    from skypilot_tpu_torch.train import Trainer, run
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run.main(['--preset', 'test-tiny', '--steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(LlamaModel(PRESETS['test-tiny']))
    assert run.parse_args([]).device == 'cuda'
    # Asked for explicitly, the CPU is fine.
    Trainer(LlamaModel(PRESETS['test-tiny'], device='cpu'))


def test_chip_smoke_alone_or_without_a_card_prints_no_result(tmp_path):
    """``chip_smoke.py`` copied into an empty directory (no port beside
    it) exits non-zero and never prints its success line — here, also
    because this machine has no CUDA device."""
    shutil.copy(os.path.join(REPO_ROOT, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, 'chip_smoke.py'],
                          capture_output=True, text=True, cwd=tmp_path,
                          env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
