"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``skypilot_tpu_torch/csrc/`` has a plain C
interface. It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) the first time a wrapper needs it, and loaded with
``ctypes``. The library's file name carries a hash of its source, so an
edited source is rebuilt and a stale library is never loaded. Nothing here
runs at import time: this module imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build', 'kernels')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# One lock per kernel, so that different kernels build in parallel (nvcc
# runs as a subprocess, outside the GIL) while one kernel builds once.
_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {'seconds': build wall time (0.0 when the library was already
# built), 'log': nvcc's output incl. -Xptxas -v register/smem report}
build_info: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of '
                       'skypilot_tpu_torch are built from source on the '
                       'machine with the GPU (put nvcc on PATH or set '
                       'CUDA_HOME)')


def library_path(name: str) -> str:
    """Path the library built from ``csrc/<name>.cu`` is kept at."""
    src = os.path.join(CSRC_DIR, f'{name}.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')


def build(name: str, nvcc: Optional[str] = None) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path. Safe across processes: each compiles to a
    private file and renames it into place."""
    out = library_path(name)
    if os.path.exists(out):
        build_info.setdefault(name, {'seconds': 0.0, 'log': ''})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(CSRC_DIR, f'{name}.cu')]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name} '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    build_info[name] = {'seconds': seconds, 'log': log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
