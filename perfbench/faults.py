"""Faults planted under the timed path, for the tests that show the
comparison catches them (never used by a benchmark run)."""
from __future__ import annotations

import dataclasses


def plant(fault: str, sched) -> None:
    """Serving faults, in the replica's scheduler."""
    eng = sched.engine
    vocab = sched.config.vocab_size
    if fault == 'token':
        # A token altered where it is produced: every decode step's output.
        verify, plain = eng.step_verify, eng.step

        def step_verify(*a, **kw):
            state, out, accept, rng = verify(*a, **kw)
            return state, (out + 1) % vocab, accept, rng

        def step(*a, **kw):
            state, out, rng = plain(*a, **kw)
            return state, (out + 1) % vocab, rng
        eng.step_verify, eng.step = step_verify, step
    elif fault == 'frozen':
        # A step that leaves its state unchanged: no decode step writes
        # its KV rows.
        write = eng._write_kv
        prefill = {'on': False}
        forward = eng._prefill_forward

        def prefill_forward(*a, **kw):
            prefill['on'] = True
            try:
                return forward(*a, **kw)
            finally:
                prefill['on'] = False

        def write_kv(*a, **kw):
            if prefill['on']:
                write(*a, **kw)
        eng._prefill_forward, eng._write_kv = prefill_forward, write_kv
    else:
        raise ValueError(f'unknown serving fault {fault!r}')


def plant_train(fault: str, trainer, step):
    """Training faults around the trainer's step."""
    if fault == 'frozen':
        def frozen(state, batch):
            import torch
            with torch.no_grad():
                loss = trainer.loss_fn(state.params, batch)
            return dataclasses.replace(state, step=state.step + 1), {
                'loss': loss, 'grad_norm': loss * 0, 'step': state.step}
        return frozen
    if fault == 'half_batch':
        # Half the batch left out; the mean taken over the rest.
        def half(state, batch):
            rows = batch['tokens'].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return half
    raise ValueError(f'unknown training fault {fault!r}')
