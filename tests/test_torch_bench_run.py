"""``python -m skypilot_tpu_torch.bench``: the orchestrator on the CPU.

One whole run with ``--device cpu`` (test-tiny: every phase, every serve
arm, in about two minutes) read by several tests: every stdout line a
complete record, the last the most complete, the JAX bench record's field
names (but the TPU-only equivalence estimate), ``vs_baseline`` null. Then
the no-fallback contract: phases hung through the ported wedge seam are
killed at their pinned budgets, the record says ``<phase>_timeout``, the
run exits non-zero and nothing is retried; without a card and without
``--device cpu`` the run refuses to start; and a process the harness
starts dies with the process that started it.
"""
import json
import math
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The fields of the JAX bench record (bench.py: phase_train's record,
# phase_launched's and _overhead_breakdown's, serve_bench.run's for the
# CPU arms and phase_serve's int8 fields, phase_decode's, the
# orchestrator's) that a healthy CPU run writes; ``equivalence_estimate``'s
# two fields are TPU bandwidth scaling and are not ported.
JAX_FIELDS = {
    'metric', 'value', 'unit', 'vs_baseline',
    'equivalent_8b_tokens_per_sec_per_chip', 'model_params_b', 'mfu_pct',
    'mfu_6n_pct', 'chip', 'seq_len', 'train_phase_s',
    'launched_job_status', 'launch_overhead_s', 'control_plane_s',
    'runtime_startup_s', 'param_init_s', 'first_step_s',
    'launched_tokens_per_sec_per_chip', 'warm_launched_job_status',
    'warm_launch_overhead_s', 'warm_control_plane_s',
    'warm_runtime_startup_s', 'warm_param_init_s', 'warm_first_step_s',
    'launched_phase_s', 'launched_vs_inprocess',
    'serve_model_params', 'serve_model_params_b', 'serve_prompt_len',
    'serve_output_len', 'serve_batch_slots', 'serve_prefill_chunk',
    'serve_ttft_slo_ms', 'serve_prefix_share_len', 'serve_kv_block',
    'serve_spec_tokens', 'serve_sweep_monolithic', 'serve_sweep',
    'serve_replica_metrics_summary', 'serve_prefix_sweep',
    'serve_prefix_hit_rate', 'serve_kv_block_utilization', 'serve_rejected',
    'serve_replica_stats', 'serve_ttft_p99_ab', 'serve_req_per_s',
    'serve_output_tokens_per_s', 'serve_ttft_p50_ms', 'serve_ttft_p99_ms',
    'serve_tpot_p50_ms', 'serve_tpot_p99_ms', 'serve_concurrency',
    'serve_sweep_int8', 'serve_int8_kv_dtype', 'serve_int8_req_per_s',
    'serve_int8_ttft_p99_ms', 'serve_int8_tpot_p50_ms', 'serve_phase_s',
    'decode_tokens_per_sec_per_chip', 'decode_batch_slots',
    'decode_ttft_ms', 'decode_prompt_len', 'decode_phase_s',
    'bench_elapsed_s'}
# What the port's record adds: the train phase's loss and step time.
PORT_FIELDS = {'train_loss', 'train_seconds_per_step'}
REQUIRED = ('metric', 'value', 'unit', 'vs_baseline')


def _bench(args, env_extra=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    t0 = time.time()
    proc = subprocess.run([sys.executable, '-m', 'skypilot_tpu_torch.bench',
                           *args], capture_output=True, text=True,
                          env=env, timeout=timeout, cwd=REPO)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.strip()]
    return proc, lines, time.time() - t0


@pytest.fixture(scope='module')
def cpu_run():
    proc, lines, _ = _bench(['--device', 'cpu'])
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc, lines


def test_every_line_is_a_complete_record(cpu_run):
    _, lines = cpu_run
    assert len(lines) == 4  # after train, launched, serve and decode
    for rec in lines:
        for key in REQUIRED:
            assert key in rec
        assert rec['vs_baseline'] is None


def test_last_line_is_the_most_complete(cpu_run):
    _, lines = cpu_run
    for earlier, later in zip(lines, lines[1:]):
        assert set(earlier) < set(later)
        for key in earlier:
            assert later[key] == earlier[key], key


def test_record_has_the_jax_fields(cpu_run):
    _, lines = cpu_run
    final = lines[-1]
    assert JAX_FIELDS <= set(final), sorted(JAX_FIELDS - set(final))
    assert set(final) - JAX_FIELDS == PORT_FIELDS
    assert not any(k.endswith('_timeout') or k.endswith('_error')
                   for k in final)


def test_phase_values(cpu_run):
    _, lines = cpu_run
    rec = lines[-1]
    assert rec['metric'] == 'train_tokens_per_sec_per_chip'
    assert rec['value'] > 0 and math.isfinite(rec['train_loss'])
    assert rec['chip'] == 'cpu' and rec['seq_len'] == 256
    assert rec['mfu_pct'] is None  # no peak rate for the host
    for prefix in ('', 'warm_'):
        assert rec[f'{prefix}launched_job_status'] == 'SUCCEEDED'
        parts = [rec[f'{prefix}{p}_s'] for p in (
            'control_plane', 'runtime_startup', 'param_init', 'first_step')]
        assert all(p >= 0 for p in parts)
        assert sum(parts) == pytest.approx(
            rec[f'{prefix}launch_overhead_s'], abs=0.05)
    assert rec['launched_tokens_per_sec_per_chip'] > 0
    assert rec['serve_req_per_s'] > 0 and rec['serve_prefix_hit_rate'] > 0
    assert len(rec['serve_sweep']) == len(rec['serve_sweep_monolithic']) == 4
    assert all(p['errors'] == 0 for p in rec['serve_sweep'])
    assert rec['serve_int8_kv_dtype'] == 'int8'
    assert rec['decode_tokens_per_sec_per_chip'] > 0
    assert rec['decode_ttft_ms'] > 0


def test_hung_phases_are_killed_at_their_budgets(tmp_path):
    """No fallback: every phase hangs, each is killed at its pinned
    budget and marked, each ran once, and the run exits non-zero."""
    env = {'SKYTPU_BENCH_WEDGE_PHASE': 'train,launched,serve,decode'}
    env.update({f'SKYTPU_BENCH_BUDGET_{p}': '3'
                for p in ('TRAIN', 'LAUNCHED', 'SERVE', 'DECODE')})
    proc, lines, wall = _bench(['--device', 'cpu'], env, timeout=300)
    assert proc.returncode != 0
    assert len(lines) == 4
    final = lines[-1]
    for phase in ('train', 'launched', 'serve', 'decode'):
        assert final[f'{phase}_timeout'] is True
        assert final[f'{phase}_budget_s'] == 3
        assert 3 <= final[f'{phase}_phase_s'] < 20
        assert proc.stderr.count(f'bench: phase {phase} ') == 1
    assert lines[0]['value'] == 0.0
    assert 'failed phases' in proc.stderr
    assert wall < 120


def test_refuses_to_start_without_a_card():
    """This machine has no CUDA device: without --device cpu the run
    exits non-zero before any phase and prints no record."""
    proc, lines, _ = _bench([], timeout=300)
    assert proc.returncode != 0
    assert lines == []
    assert 'no CUDA device' in proc.stderr
    assert 'bench: phase' not in proc.stderr


def test_a_spawned_process_dies_with_its_parent():
    """A replica or trainer a phase started dies when the phase is
    killed: the parent here spawns a sleeper and is SIGKILLed."""
    from skypilot_tpu_torch.benchmark import serve_bench as sb
    code = ('import os, sys, time\n'
            'from skypilot_tpu_torch.benchmark import serve_bench as sb\n'
            "p = sb.spawn([sys.executable, '-c', 'import time; "
            "time.sleep(600)'], dict(os.environ), None)\n"
            'print(p.pid, flush=True)\n'
            'time.sleep(600)\n')
    parent = subprocess.Popen([sys.executable, '-c', code],
                              stdout=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=REPO),
                              start_new_session=True)
    child = int(parent.stdout.readline())
    time.sleep(1.0)  # the wrapper has exec'd the sleeper
    assert os.getpgid(child) == child != os.getpgid(parent.pid)
    sb.kill_group(parent, grace_s=0.0)
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            with open(f'/proc/{child}/status') as f:
                state = next(ln for ln in f if ln.startswith('State:'))
            if 'Z' in state.split()[1]:
                break  # killed, waiting for its new parent to reap it
        except (FileNotFoundError, ProcessLookupError):
            break
        time.sleep(0.2)
    else:
        os.killpg(child, 9)
        pytest.fail('the spawned process outlived its parent')
