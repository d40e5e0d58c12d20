"""The harness driven end to end on the CPU at tiny sizes: it finds new
cells, mixes, configurations and metrics as files, reports no device
metric from a CPU run, refuses to run without a card, and its comparison
turns ``correct`` false under each fault the cells can have and under
the fp8 control."""
import os
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import registry, run, serve
from perfbench import train as train_cell
from perfbench.reference import train as ref_train
from perfbench.tests import tiny


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    dest = str(tmp_path_factory.mktemp('bench'))
    return tiny.make_tree(dest), dest


def _run(tree, cell, seed=3_000_000_019, seconds=3.0, trace=0, fault=None):
    here, root = tree
    args = run.parse_args(['--workload', cell, '--seed', str(seed),
                           '--seconds', str(seconds), '--trace',
                           str(trace)])
    return run.run_cell(args, time.perf_counter(), device='cpu', here=here,
                        root=root, fault=fault,
                        cache=os.path.join(root, 'cache'))


@pytest.mark.parametrize('cell', ['tiny-dense.conv', 'tiny-moe.conv',
                                  'tiny-dense.train'])
def test_cpu_rehearsal_is_correct_and_reports_no_device_metric(tree, cell):
    res = _run(tree, cell, trace=1)
    assert res['correct'], res['checks']
    assert res['metrics'] == {}
    assert res['device']['platform'] == 'cpu'
    assert res['device']['kind'] == 'cpu'
    assert res['attempted'] > 0 and res['failed'] == 0
    assert list(res)[-1] == 'checks'
    for check in res['checks'].values():
        assert set(check) == {'value', 'limit'}


@pytest.mark.parametrize('cell,fault', [
    ('tiny-dense.conv', 'token'), ('tiny-dense.conv', 'frozen'),
    ('tiny-moe.conv', 'token'), ('tiny-dense.train', 'frozen'),
    ('tiny-dense.train', 'half_batch')])
def test_faults_turn_correct_false(tree, cell, fault):
    res = _run(tree, cell, fault=fault)
    assert not res['correct'], res['checks']


def test_serving_control_fails_its_limit(tree):
    """The fp8 reference in the program's place: at every served
    position, the token it puts first lies below the f32 best by more
    than the cell's limit on some seed of three, and the program does
    not."""
    here, root = tree
    worst = 0.0
    for seed in (1, 2, 3):
        args = run.parse_args(['--workload', 'tiny-dense.conv', '--seed',
                               str(seed), '--seconds', '3'])
        env = run.environment(os.path.join(root, 'cache'))
        os.environ.update(env)
        cell = registry.cell('tiny-dense.conv', here)
        ctx = {'args': args, 'cell': cell,
               'config': registry.config(cell['config'], here),
               'mix': registry.mix(cell['traffic'], here),
               't0': time.perf_counter(), 'device': 'cpu', 'env': env,
               'scratch': os.path.join(root, 'cache')}
        got = serve.compare(serve.run(ctx), 'cpu', (None, 'fp8'))
        assert got['gap_max'] <= cell['limits']['gap_max']
        worst = max(worst, got['ctl_gap_max'])
    assert worst > cell['limits']['gap_max']


def test_training_control_fails_its_limit(tree):
    here, _ = tree
    cell = registry.cell('tiny-dense.train', here)
    cfg = registry.config(cell['config'], here)
    mix = registry.mix(cell['traffic'], here)
    from perfbench import yardstick
    dims = dict(yardstick.model_dims(cfg),
                layers=cfg['train']['num_hidden_layers'])
    for seed in (1, 2, 3):
        rows = [train_cell.batch_tokens(seed, k, mix['batch'], mix['seq'],
                                        dims['v'], 'cpu') for k in range(3)]
        ref = ref_train.train_steps(dims, cfg, seed, rows, 3e-4, 'cpu')
        ctl = ref_train.train_steps(dims, cfg, seed, rows, 3e-4, 'cpu',
                                    'fp8')
        got = train_cell.gaps(ctl, ref)
        assert any(got[k] > v for k, v in cell['limits'].items()), got


def test_a_new_metric_is_a_new_file(tree):
    here, root = tree
    with open(os.path.join(here, 'metrics', 'served_requests.py'),
              'w') as f:
        f.write('def read(run):\n'
                '    return len(run.get("records", [])) or None\n')
    bench = registry.benchmark(root)
    bench['per_layer'].append({
        'name': 'served_requests', 'unit': 'requests', 'better': 'higher',
        'source': 'host_clock', 'layer': 'front end and scheduler',
        'moves': 'ttft_p75_ms', 'workloads': ['tiny-dense.conv']})
    entries = registry.metrics_for(bench, 'tiny-dense.conv', True)
    assert entries[-1]['name'] == 'served_requests'
    got = registry.read_metrics(entries[-1:], {'kind': 'serve',
                                               'records': [1, 2, 3]}, here)
    assert got == {'served_requests': {'value': 3.0, 'unit': 'requests'}}
    assert registry.metrics_for(bench, 'tiny-dense.train', True) == [
        m for m in bench['per_layer'] if 'tiny-dense.train' in
        m['workloads']]


def test_main_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    assert run.main(['--workload', 'mistral-7b.conv', '--seed', '1',
                     '--seconds', '10', '--trace', '0']) == 2
    assert capsys.readouterr().out == ''


def test_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ cannot run a
    cell: the replica cannot load the system under test."""
    shutil.copytree(registry.HERE, tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    shutil.copy(os.path.join(registry.ROOT, 'BENCHMARK.json'), tmp_path)
    tiny.make_tree(str(tmp_path / 'data'))
    code = ('import time, json; from perfbench import run; '
            'a = run.parse_args(["--workload", "tiny-dense.conv", '
            '"--seed", "1", "--seconds", "2"]); '
            f'print(json.dumps(run.run_cell(a, time.perf_counter(), '
            f'"cpu", here={str(tmp_path / "data" / "perfbench")!r}, '
            f'root={str(tmp_path / "data")!r})))')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'skypilot_tpu_torch' in out.stderr
