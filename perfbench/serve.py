"""A serving cell: one replica of the port in a child process
(``perfbench.replica``), open-loop load from this process, and the
served tokens held against the f32 reference once the window closes.

Set-up runs from process start to the first due request: the replica's
imports, its weights drawn on the card, its own warm-up, one request at
each prefill length the cell's traffic will use, and the admission of
the steady-state set (``traffic.in_flight``), so that the window opens
on a replica as full as the cell's rate keeps it. Then requests are
offered at the cell's fixed rate for the window. After it closes the
load goes on as scheduled until every request due in the window has its
first token (or ``grace_s`` passes), so each is timed under the load it
met; tokens that arrive after the close are not counted as output of
the window.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List

from perfbench import (devtrace, loadgen, promtext, readers, registry,
                       traffic, yardstick)


class Replica:
    """The child process and its command pipe."""

    def __init__(self, args: Dict, env: Dict[str, str]):
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'perfbench.replica'], cwd=registry.ROOT,
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)
        self.lock = threading.Lock()
        self.port = self._send(args)['port']

    def _send(self, obj: Dict) -> Dict:
        with self.lock:
            self.proc.stdin.write(json.dumps(obj) + '\n')
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f'replica exited (code {self.proc.poll()})')
        return json.loads(line)

    def command(self, op: str, **kw) -> Dict:
        return self._send({'op': op, **kw})

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.command('stop')
            except (RuntimeError, OSError, ValueError):
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def scrape(port: int) -> Dict[str, float]:
    with urllib.request.urlopen(f'http://127.0.0.1:{port}/metrics',
                                timeout=30) as resp:
        return promtext.parse(resp.read().decode())


def _clip(reqs: List[traffic.Request], max_len: int) -> None:
    """Keep every request inside the replica's cache: prompt + output
    below max_len (the mix's clips allow a sum one row past it)."""
    for r in reqs:
        r.max_tokens = max(1, min(r.max_tokens, max_len - 1 - len(r.prompt)))


def steady_requests(ctx: Dict, rate: float) -> List[traffic.Request]:
    """The steady-state set the cell admits during set-up (none without
    ``steady_tpot_s`` in the cell)."""
    cell, cfg = ctx['cell'], ctx['config']
    tpot = cell.get('steady_tpot_s')
    if not tpot:
        return []
    return traffic.in_flight(ctx['mix'], rate, float(tpot), ctx['args'].seed,
                             yardstick.model_dims(cfg)['v'],
                             cfg['serve']['max_len'])


def warm_requests(reqs: List[traffic.Request], max_len: int, vocab: int,
                  seed: int) -> List[traffic.Request]:
    """One short request at each prefill length the replica will run for
    ``reqs`` (its buckets), due at once; its prompt fills the bucket but
    for room for its four tokens."""
    from skypilot_tpu_torch.models.decode import prefill_bucket
    buckets = sorted({prefill_bucket(len(r.prompt), max_len) for r in reqs})
    rnd = random.Random(f'warm/{seed}')
    return [traffic.Request(-1 - i, 0.0, [rnd.randrange(vocab) for _ in
                                          range(min(b, max_len - 5))], 4)
            for i, b in enumerate(buckets)]


def run(ctx: Dict) -> Dict:
    """Drive one serving run; returns the run record the metric readers
    and the comparison take."""
    args, cell, cfg = ctx['args'], ctx['cell'], ctx['config']
    dims = yardstick.model_dims(cfg)
    eng = cfg['serve']
    seconds, grace = float(args.seconds), float(cell['grace_s'])
    rate = float(cell['rate_per_s'])
    reqs = traffic.schedule(ctx['mix'], rate, seconds, grace, args.seed,
                            dims['v'])
    _clip(reqs, eng['max_len'])
    steady = steady_requests(ctx, rate)
    child = {'config': cfg, 'engine': eng, 'seed': args.seed,
             'device': ctx['device'], 'fault': ctx.get('fault')}
    replica = Replica(child, ctx['env'])
    run_rec: Dict = {'kind': 'serve', 'dims': dims, 'config': cfg,
                     'cell': cell, 'seed': args.seed}
    after: Dict[str, Dict] = {}
    before: Dict[str, Dict] = {}
    prof: Dict = {}
    threads: List[threading.Thread] = []

    def on_start(start: float) -> None:
        before['m'] = scrape(replica.port)
        timer = threading.Timer(
            start + seconds - time.perf_counter(),
            lambda: after.update(m=scrape(replica.port)))
        timer.start()
        threads.append(timer)
        if args.trace:
            threads.append(threading.Thread(
                target=_profile, args=(replica, start, seconds, cell, prof,
                                       ctx['scratch'])))
            threads[-1].start()
    try:
        warm = warm_requests(reqs + steady, eng['max_len'], dims['v'],
                             args.seed)
        warm_recs = loadgen.run_all('127.0.0.1', replica.port, warm, 600.0)
        bad = [r.error for r in warm_recs if not r.finished]
        if bad:
            raise RuntimeError(f'warm-up requests failed: {bad[:3]}')
        held, records, start = loadgen.run(
            '127.0.0.1', replica.port, reqs, seconds, grace, steady=steady,
            need=min(len(steady), eng['batch_slots']), on_start=on_start)
        run_rec['setup_s'] = start - ctx['t0']
        drained = time.perf_counter()
        for t in threads:
            t.join()
        peak = replica.command('peak')
    finally:
        replica.close()
    run_rec.update(records=records, steady=held,
                   window=(start, start + seconds), drained=drained,
                   metrics_before=before.get('m', {}),
                   metrics_after=after.get('m', {}),
                   memory_peak_bytes=peak['memory_peak_bytes'],
                   child_forbidden=peak['forbidden'])
    if prof.get('path'):
        run_rec['trace'] = dict(
            devtrace.load(prof['path'], keep=(readers.K1_KERNEL,)),
            t0=prof['t0'], t1=prof['t1'], window_s=prof['t1'] - prof['t0'])
        os.remove(prof['path'])
    return run_rec


def _profile(replica: Replica, start: float, seconds: float, cell: Dict,
             out: Dict, scratch: str) -> None:
    """A CUDA trace of part of the window: from ``trace_offset`` of the
    window for ``trace_s`` seconds."""
    offset = float(cell['trace_offset']) * seconds
    length = min(float(cell['trace_s']), seconds - offset)
    time.sleep(max(0.0, start + offset - time.perf_counter()))
    out['t0'] = replica.command('profile_start')['t']
    time.sleep(max(0.0, out['t0'] + length - time.perf_counter()))
    path = os.path.join(scratch, f'serve_trace_{os.getpid()}.json')
    out['t1'] = replica.command('profile_stop', path=path)['t']
    out['path'] = path


def in_window(run_rec: Dict) -> List[loadgen.Record]:
    """The requests a run attempts: the steady-state set and those due
    in the window."""
    start, close_at = run_rec['window']
    return run_rec.get('steady', []) + [r for r in run_rec['records']
                                         if r.due < close_at]


def failed(run_rec: Dict) -> List[loadgen.Record]:
    """Attempted requests that failed, or (due in the window) never got a
    first token; one cut off when the run ends has not failed."""
    steady = run_rec.get('steady', [])
    due = in_window(run_rec)[len(steady):]
    return ([r for r in steady if r.error is not None]
            + [r for r in due if r.error is not None or r.first is None])


def sample(run_rec: Dict, check: Dict) -> List[loadgen.Record]:
    """Finished requests to compare (the steady-state set's among them),
    drawn from the seed, the one with the most served tokens first."""
    done = [r for r in run_rec['records'] + run_rec.get('steady', [])
            if r.finished]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.request.index))
    rnd = random.Random(f'sample/{run_rec["seed"]}')
    rest = done[1:]
    rnd.shuffle(rest)
    picked = [done[0]]
    served = len(done[0].tokens)
    total = len(done[0].request.prompt) + served
    for r in rest:
        if (served >= check['served_tokens']
                or len(picked) >= check['max_requests']):
            break
        size = len(r.request.prompt) + len(r.tokens)
        if total + size > check['max_sequence_tokens']:
            continue
        picked.append(r)
        served += len(r.tokens)
        total += size
    return picked


def compare(run_rec: Dict, device, lowp_list=(None,)) -> Dict:
    """Teacher-forced f32 logits over each sampled prompt and its served
    tokens; per served token the gap by which its logit lies below the
    reference's best. With 'fp8' in ``lowp_list`` also the gap of the
    token the fp8 control puts first, at the same positions."""
    import torch
    from perfbench.reference import model as ref
    check = run_rec['cell']['check']
    picked = sample(run_rec, check)
    vocab = run_rec['dims']['v']
    if not picked:
        return {'served': 0}
    seqs, rows, served = [], [], []
    for r in picked:
        p = r.request.prompt
        seqs.append(torch.tensor(p + r.tokens[:-1], dtype=torch.long))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(r.tokens)))
        served.append(torch.tensor(r.tokens, dtype=torch.long))
    in_vocab = all(0 <= t < vocab for r in picked for t in r.tokens)
    logits = ref.score_logits(seqs, rows, run_rec['config'],
                              run_rec['dims'], run_rec['seed'], device,
                              lowp_list)
    gaps = []
    ctl = []
    for i, lg in enumerate(logits[None]):
        best = lg.max(-1).values
        tok = served[i].to(lg.device)
        gaps.append(best - lg.gather(1, tok[:, None])[:, 0])
        if 'fp8' in logits:
            pick = logits['fp8'][i].argmax(-1)
            ctl.append(best - lg.gather(1, pick[:, None])[:, 0])
    gaps = torch.cat(gaps)
    out = {'served': int(gaps.numel()), 'requests': len(picked),
           'in_vocab': in_vocab, 'gap_max': float(gaps.max()),
           'gap_mean': float(gaps.mean())}
    if ctl:
        ctl = torch.cat(ctl)
        out.update(ctl_gap_max=float(ctl.max()), ctl_gap_mean=float(
            ctl.mean()))
    return out
