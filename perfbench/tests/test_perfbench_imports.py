"""Nothing a run loads is JAX or the JAX package (names compared whole,
by the part before the first dot), and the references import nothing of
the port."""
import ast
import os
import subprocess
import sys

from perfbench import guard, registry


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split('.')[0]


def _sources(sub=''):
    for dirpath, dirs, files in os.walk(os.path.join(registry.HERE, sub)):
        dirs[:] = [d for d in dirs if d not in ('tests', '.cache',
                                                '__pycache__')]
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(
        ['skypilot_tpu_torch', 'skypilot_tpu_torch.models', 'jaxtyping',
         'numpy']) == []
    assert guard.forbidden_loaded(
        ['jax.numpy', 'jaxlib', 'flax.linen', 'skypilot_tpu.models']) == [
        'flax', 'jax', 'jaxlib', 'skypilot_tpu']


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(guard.FORBIDDEN)
        assert not bad, f'{path} imports {bad}'


def test_references_import_nothing_of_the_port():
    for path in _sources('reference'):
        names = set(_imports(path))
        assert 'skypilot_tpu_torch' not in names, path
        assert names <= {'__future__', 'functools', 'typing', 'torch',
                         'perfbench'}, (path, names)


def test_a_run_loads_no_jax():
    code = ('import perfbench.run, perfbench.serve, perfbench.train, '
            'perfbench.replica, perfbench.program, perfbench.controls; '
            'import skypilot_tpu_torch.serve.generation_server, '
            'skypilot_tpu_torch.train.step, '
            'skypilot_tpu_torch.models.mixtral; '
            'from perfbench import guard; print(guard.forbidden_loaded())')
    env = guard.quiet_env({k: v for k, v in os.environ.items()
                           if k != 'PYTHONPATH'})
    out = subprocess.run([sys.executable, '-c', code], cwd=registry.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
