"""The JAX package's control plane drives the port's entry points.

The serve controller and load balancer (``serve_core.up`` on the local
cloud) stand up a service whose replica is the port's
``skypilot_tpu_torch.serve.generation_server`` on the CPU; the port's
``drive_load`` completes requests through the load balancer's endpoint.
Then ``execution.launch`` runs the port's trainer as a job and leaves the
callback summary with every mark the launch-overhead split reads. The
port imports nothing of JAX: only this test imports both.
"""
import json
import os
import sys
import tempfile
import time

import pytest

import skypilot_tpu as sky
from skypilot_tpu import core, execution
from skypilot_tpu.runtime import job_lib
from skypilot_tpu.serve import core as serve_core
from skypilot_tpu.serve import serve_state
from skypilot_tpu.serve import service_spec as spec_lib
from skypilot_tpu_torch.benchmark import serve_bench

pytestmark = pytest.mark.e2e


def _wait(predicate, timeout, what, interval=0.3):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise TimeoutError(f'timed out waiting for {what}')


def test_serve_controller_and_lb_drive_the_port_replica(monkeypatch):
    monkeypatch.setenv('SKYTPU_SERVE_TICK', '0.2')
    monkeypatch.setenv('SKYTPU_SERVE_LB_SYNC', '0.2')
    task = sky.Task(
        run=(f'{sys.executable} -m skypilot_tpu_torch.serve.'
             'generation_server --device cpu --preset test-tiny '
             '--batch-slots 2 --max-len 128'),
        envs={'SKYTPU_PREFILL_CHUNK': '8', 'SKYTPU_KV_BLOCK': '8'})
    task.set_resources([sky.Resources(cloud='local')])
    task.set_service(spec_lib.ServiceSpec.from_yaml_config({
        'readiness_probe': {'path': '/health', 'initial_delay_seconds': 120,
                            'timeout_seconds': 5},
        'replica_policy': {'min_replicas': 1, 'max_replicas': 1},
    }))
    endpoint = serve_core.up(task, 'torch-svc')['endpoint']
    try:
        _wait(lambda: [r for r in serve_state.list_replicas('torch-svc')
                       if r['status'] == serve_state.ReplicaStatus.READY],
              180, 'the port replica READY')
        # The LB may take a sync tick to route to the READY replica.
        _wait(lambda: serve_bench.drive_load(
            endpoint, vocab_size=256, prompt_len=24, output_len=4,
            concurrency=1, window_s=1.0, seed=5)['completed'], 60,
            'a request through the load balancer', interval=0.5)
        stats = serve_bench.drive_load(
            endpoint, vocab_size=256, prompt_len=24, output_len=8,
            concurrency=2, window_s=3.0, seed=1)
        assert stats['completed'] > 0 and stats['errors'] == 0, stats
        assert stats['ttft_p50_ms'] > 0 and stats['tpot_p50_ms'] > 0
        replica = serve_state.list_replicas('torch-svc')[0]['url']
        got = serve_bench._fetch_stats(replica.rstrip('/'))
        assert got['prefill_chunk'] == 8 and got['kv_block'] == 8
        assert got['requests'] >= stats['completed']
    finally:
        serve_core.down('torch-svc')
    assert serve_state.get_service('torch-svc') is None


def test_launch_runs_the_port_trainer_with_the_callback_marks():
    log_dir = tempfile.mkdtemp(prefix='torch-cb-')
    task = sky.Task(
        run=(f'{sys.executable} -m skypilot_tpu_torch.train.run --device '
             'cpu --preset test-tiny --batch 2 --seq 64 --steps 3 '
             '--log-every 3'),
        envs={'SKYTPU_BENCHMARK_LOG_DIR': log_dir})
    task.set_resources([sky.Resources(cloud='local')])
    t_submit = time.time()
    job_id, _ = execution.launch(task, cluster_name='torch-train',
                                 detach_run=True, stream_logs=False)
    try:
        def terminal():
            try:
                status = core.job_status('torch-train', job_id)
            except Exception:  # noqa: BLE001 — agent heartbeat lag
                return None
            return status if status and job_lib.JobStatus(
                status).is_terminal() else None
        assert _wait(terminal, 180, 'the trainer job') == 'SUCCEEDED'
        with open(os.path.join(log_dir, 'benchmark_summary.json')) as f:
            summary = json.load(f)
    finally:
        core.down('torch-train')
    marks = summary['marks']
    stamps = [t_submit, marks['proc_start'], marks['jax_ready'],
              marks['init_done'], summary['first_step_end_ts']]
    assert stamps == sorted(stamps)
    assert summary['num_steps'] == 3 and summary['seconds_per_step'] > 0
