"""A copy of the benchmark's files with tiny configurations, for the CPU
tests: the harness run from it finds them by name, as it finds the real
ones."""
from __future__ import annotations

import json
import os
import shutil

from perfbench import registry

TINY_DENSE = {
    'name': 'tiny-dense', 'source': 'test', 'model': 'mistral',
    'hidden_size': 64, 'intermediate_size': 128,
    'max_position_embeddings': 512, 'num_attention_heads': 4,
    'num_hidden_layers': 2, 'num_key_value_heads': 2, 'head_dim': 16,
    'rms_norm_eps': 1e-5, 'rope_theta': 10000.0,
    'tie_word_embeddings': False, 'vocab_size': 256,
    'serve': {'batch_slots': 4, 'max_len': 256, 'kv_block': 16,
              'kv_blocks': 80, 'kv_dtype': 'bf16', 'spec_tokens': 4,
              'inflight_steps': 2, 'prefill_chunk': 0},
    'train': {'num_hidden_layers': 2, 'remat': 'dots', 'lr': 3e-4},
}
TINY_MOE = dict(TINY_DENSE, name='tiny-moe', model='mixtral',
                num_local_experts=4, num_experts_per_tok=2,
                capacity_factor=2.0)
TINY_MIX = {'name': 'tiny-conv', 'prompt': {'median': 24, 'sigma': 0.8,
                                            'min': 8, 'max': 96},
            'output': {'median': 8, 'sigma': 0.5, 'min': 2, 'max': 24}}
TINY_TRAIN = {'name': 'tiny-train', 'batch': 2, 'seq': 32}
SERVE_CELL = {'kind': 'serve', 'chips': 1, 'grace_s': 30,
              'steady_tpot_s': 0.05,
              'rate_per_s': 4.0, 'trace_offset': 0.25, 'trace_s': 1.0,
              'check': {'served_tokens': 40, 'min_served_tokens': 10,
                        'max_requests': 4, 'max_sequence_tokens': 2000},
              'limits': {'gap_max': 0.02}}


def make_tree(dest: str) -> str:
    """A copy of perfbench's data and readers under ``dest`` with the tiny
    cells added; returns the copy's ``perfbench`` directory (its root is
    ``dest``)."""
    here = os.path.join(dest, 'perfbench')
    for sub in ('configs', 'workloads', 'traffic', 'metrics'):
        shutil.copytree(os.path.join(registry.HERE, sub),
                        os.path.join(here, sub))
    shutil.copy(os.path.join(registry.ROOT, 'BENCHMARK.json'), dest)

    def put(sub, name, obj):
        with open(os.path.join(here, sub, f'{name}.json'), 'w') as f:
            json.dump(obj, f)
    put('configs', 'tiny-dense', TINY_DENSE)
    put('configs', 'tiny-moe', TINY_MOE)
    put('traffic', 'tiny-conv', TINY_MIX)
    put('traffic', 'tiny-train', TINY_TRAIN)
    put('workloads', 'tiny-dense.conv',
        dict(SERVE_CELL, config='tiny-dense', traffic='tiny-conv'))
    put('workloads', 'tiny-moe.conv',
        dict(SERVE_CELL, config='tiny-moe', traffic='tiny-conv'))
    put('workloads', 'tiny-dense.train',
        {'kind': 'train', 'chips': 1, 'config': 'tiny-dense',
         'traffic': 'tiny-train',
         'limits': {'loss_gap': 0.004, 'grad_gap': 0.02,
                    'change_gap': 0.05}})
    bench_path = os.path.join(dest, 'BENCHMARK.json')
    with open(bench_path) as f:
        bench = json.load(f)
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            kind = 'train' if any('train' in w for w in m['workloads']) \
                else 'conv'
            m['workloads'] += [f'tiny-dense.{kind}'] + (
                ['tiny-moe.conv'] if kind == 'conv' else [])
    with open(bench_path, 'w') as f:
        json.dump(bench, f)
    return here
