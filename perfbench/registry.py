"""Everything a run needs, found by the names in ``BENCHMARK.json``.

A cell is ``workloads/<cell>.json``, a configuration
``configs/<config>.json``, a traffic mix ``traffic/<mix>.json`` and a
metric ``metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None). A later cell, mix, configuration or metric is a new file.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts: str) -> Dict:
    with open(os.path.join(*parts), encoding='utf-8') as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(root, 'BENCHMARK.json')


# What a cell file may leave out: the traced part of the window (from
# ``trace_offset`` of it, for ``trace_s`` seconds: long enough to hold
# some tens of prefills or steps, short enough to parse), and how long a
# serving run waits after the close for the first tokens of requests due
# in the window.
CELL_DEFAULTS = {'trace_offset': 0.3, 'trace_s': 12.0, 'grace_s': 15.0}


def cell(name: str, here: str = HERE) -> Dict:
    return dict(CELL_DEFAULTS, **_json(here, 'workloads', f'{name}.json'))


def config(name: str, here: str = HERE) -> Dict:
    return _json(here, 'configs', f'{name}.json')


def mix(name: str, here: str = HERE) -> Dict:
    return _json(here, 'traffic', f'{name}.json')


def reader(metric: str, here: str = HERE) -> Callable:
    path = os.path.join(here, 'metrics', f'{metric}.py')
    mod_name = 'perfbench_metric_' + ''.join(
        c if c.isalnum() else '_' for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: Dict, cell_name: str, trace: bool
                ) -> List[Dict]:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones, or with a trace the per-layer ones, that name it or name no
    cells."""
    key = 'per_layer' if trace else 'end_to_end'
    return [m for m in bench[key]
            if 'workloads' not in m or cell_name in m['workloads']]


def read_metrics(entries: List[Dict], run: Dict, here: str = HERE
                 ) -> Dict[str, Dict]:
    """name -> {'value', 'unit'} for each entry whose reader found
    something to read."""
    out: Dict[str, Dict] = {}
    for m in entries:
        value: Optional[float] = reader(m['name'], here)(run)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out
