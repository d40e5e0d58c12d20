"""On the card: each cell's control at the cell's own size fails one of
its numbers, and the program on the same seed passes them. Run there
with ``python3 -m pytest perfbench/tests -m cuda``; each case takes a
few minutes."""
import json
import subprocess
import sys

import pytest

from perfbench import registry

SEED = 2_147_483_659


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in
                                  registry.benchmark()['workloads']])
def test_control_fails_and_program_passes_at_size(cell):
    _card()
    out = subprocess.run(
        [sys.executable, '-m', 'perfbench.controls', '--workload', cell,
         '--seeds', str(SEED), '--seconds', '40'], cwd=registry.ROOT,
        capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    limits = registry.cell(cell)['limits']
    if registry.cell(cell)['kind'] == 'serve':
        prog = {k: got[k] for k in limits}
        ctl = {k: got['ctl_' + k] for k in limits}
    else:
        prog = {k: got['program'][k] for k in limits}
        ctl = {k: got['control'][k] for k in limits}
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in limits), ctl
