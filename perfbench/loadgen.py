"""Open-loop load: each request is sent when it is due, whether or not
earlier ones have finished, from one thread (asyncio), and its tokens
are read as the replica streams them.

Times are ``time.perf_counter()`` seconds. A request's TTFT runs from
when it was due, so a stall of the generator or of the replica counts
against every request it delays.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Callable, List, Optional, Sequence, Tuple

from perfbench.traffic import Request

# How long set-up may take to admit the steady-state set.
ADMIT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Record:
    request: Request
    due: float = 0.0
    sent: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None

    @property
    def first(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    @property
    def finished(self) -> bool:
        return (self.done and self.error is None
                and len(self.tokens) == self.request.max_tokens)


async def _read_line(reader) -> bytes:
    line = await reader.readline()
    if not line:
        raise ConnectionError('replica closed the connection')
    return line


async def _one(host: str, port: int, rec: Record) -> None:
    delay = rec.due - time.perf_counter()
    if delay > 0:
        await asyncio.sleep(delay)
    body = json.dumps({'tokens': rec.request.prompt,
                       'max_tokens': rec.request.max_tokens,
                       'temperature': 0.0, 'stream': True}).encode()
    head = (f'POST /generate HTTP/1.1\r\nHost: {host}\r\n'
            'Content-Type: application/json\r\n'
            f'Content-Length: {len(body)}\r\n\r\n').encode()
    rec.sent = time.perf_counter()
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port,
                                                       limit=1 << 22)
        writer.write(head + body)
        await writer.drain()
        status = (await _read_line(reader)).split()
        if len(status) < 2 or status[1] != b'200':
            rec.error = f'HTTP {status[1:2]}'
            return
        while (await _read_line(reader)) not in (b'\r\n', b'\n'):
            pass  # headers
        while True:
            size = int((await _read_line(reader)).strip() or b'0', 16)
            if size == 0:
                break
            data = await reader.readexactly(size + 2)
            now = time.perf_counter()
            for line in data[:size].splitlines():
                msg = json.loads(line)
                if 'token' in msg:
                    rec.tokens.append(int(msg['token']))
                    rec.token_times.append(now)
                elif msg.get('done'):
                    rec.done = True
                    if msg.get('error'):
                        rec.error = str(msg['error'])
    except (OSError, ConnectionError, ValueError,
            asyncio.IncompleteReadError) as e:
        rec.error = f'{type(e).__name__}: {e}'
    finally:
        if writer is not None:
            writer.close()


async def _wait(tasks, close_at: float, must_start: Sequence[Record],
                deadline: float, to_end: bool) -> None:
    """After ``close_at``, stop once each of ``must_start`` has its first
    token (``to_end``: its last), failed, or ``deadline`` passed; then
    cancel ``tasks``."""
    def settled(r: Record) -> bool:
        if r.error is not None or r.done:
            return True
        return not to_end and r.first is not None
    try:
        while True:
            now = time.perf_counter()
            if now >= close_at and (now >= deadline or all(
                    settled(r) for r in must_start)):
                break
            await asyncio.sleep(0.02)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def _serve(host, port, steady: Sequence[Request], need: int,
                 requests: Sequence[Request], window_s: float,
                 grace_s: float, on_start: Optional[Callable[[float], None]]):
    now = time.perf_counter()
    held = [Record(r, due=now) for r in steady]
    tasks = [asyncio.ensure_future(_one(host, port, r)) for r in held]
    try:
        deadline = now + ADMIT_TIMEOUT_S
        while sum(1 for r in held if r.first is not None) < need:
            bad = [r.error for r in held if r.error is not None]
            if bad or time.perf_counter() > deadline:
                raise RuntimeError(
                    f'steady-state requests not admitted: '
                    f'{sum(1 for r in held if r.first)}/{need} '
                    f'started, errors {bad[:3]}')
            await asyncio.sleep(0.02)
        start = time.perf_counter() + 0.2
        if on_start is not None:
            on_start(start)
        records = [Record(r, due=start + r.offset_s) for r in requests]
        close_at = start + window_s
        tasks += [asyncio.ensure_future(_one(host, port, r))
                  for r in records]
        await _wait(tasks, close_at, [r for r in records
                                      if r.due < close_at],
                    close_at + grace_s, False)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    return held, records, start


def run(host: str, port: int, requests: Sequence[Request], window_s: float,
        grace_s: float, steady: Sequence[Request] = (), need: int = 0,
        on_start: Optional[Callable[[float], None]] = None
        ) -> Tuple[List[Record], List[Record], float]:
    """Admit ``steady`` at once and wait until ``need`` of them have their
    first token (set-up); then offer ``requests`` from ``start`` on
    (``on_start(start)`` is called first). The window closes at start +
    window_s, and the load goes on (as scheduled) until every request
    due in the window has its first token, or grace_s more seconds.
    Returns the steady-state records, the scheduled ones, and start."""
    return asyncio.run(_serve(host, port, steady, need, requests, window_s,
                              grace_s, on_start))


def run_all(host: str, port: int, requests: Sequence[Request],
            timeout_s: float) -> List[Record]:
    """Send every request at once and wait for each to end."""
    now = time.perf_counter()
    records = [Record(r, due=now) for r in requests]

    async def drive():
        tasks = [asyncio.ensure_future(_one(host, port, r))
                 for r in records]
        await _wait(tasks, now, records, now + timeout_s, True)
    asyncio.run(drive())
    return records
