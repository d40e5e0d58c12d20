"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``skypilot_tpu_torch/csrc/`` has a plain C
interface and may include the shared headers beside it (``csrc/*.cuh``,
e.g. ``sm90.cuh``). It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``) the first time a wrapper needs it, and loaded
with ``ctypes``. The library's file name carries a hash of its source,
every header in its directory and the compiler flags, so an edited source
or header, or a changed flag, is rebuilt and a stale library is never
loaded. Nothing here runs at import time: this module imports on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
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
# built), 'log': nvcc's output incl. -Xptxas -v register/smem report,
# 'path': the library}
build_info: Dict[str, Dict[str, object]] = {}


def _toolkit_bin(tool: str) -> str:
    for cand in (shutil.which(tool),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', tool)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f'{tool} not found: the CUDA kernels of '
                       'skypilot_tpu_torch are built from source on the '
                       'machine with the GPU (put the CUDA toolkit on PATH '
                       'or set CUDA_HOME)')


def find_nvcc() -> str:
    return _toolkit_bin('nvcc')


def library_path(name: str, csrc_dir: str = CSRC_DIR,
                 build_dir: str = BUILD_DIR) -> str:
    """Path the library built from ``<csrc_dir>/<name>.cu`` is kept at:
    named by a hash of that source, every ``*.cuh`` header in
    ``csrc_dir`` (any of them may be included) and ``NVCC_FLAGS``."""
    digest = hashlib.sha256()
    sources = [os.path.join(csrc_dir, f'{name}.cu')]
    sources += sorted(glob.glob(os.path.join(csrc_dir, '*.cuh')))
    for path in sources:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0')
            digest.update(f.read() + b'\0')
    digest.update('\0'.join(NVCC_FLAGS).encode())
    return os.path.join(build_dir, f'lib{name}_{digest.hexdigest()[:12]}.so')


def build(name: str, nvcc: Optional[str] = None, csrc_dir: str = CSRC_DIR,
          build_dir: str = BUILD_DIR) -> str:
    """Compile ``<csrc_dir>/<name>.cu`` unless its library already exists;
    returns the library path. Safe across processes: each compiles to a
    private file and renames it into place."""
    out = library_path(name, csrc_dir, build_dir)
    if os.path.exists(out):
        build_info.setdefault(name, {'seconds': 0.0, 'log': '', 'path': out})
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(csrc_dir, f'{name}.cu')]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name} '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    build_info[name] = {'seconds': seconds, 'log': log, 'path': out}
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


SASS_OPS = ('HGMMA', 'UTMALDG')


def short_name(mangled: str) -> str:
    """``flash_fwd_kernel<128>`` for the mangled name of that template
    instance (the name itself when it is no such instance)."""
    # ...<length><name>ILi<D>E: the shortest name ending in _kernel that
    # its length prefix fits (hashes before it may end in digits).
    m = re.search(r'_kernelILi(\d+)E', mangled)
    if m:
        end = m.start() + len('_kernel')
        for n in range(len('_kernel'), end + 1):
            if mangled[:end - n].endswith(str(n)):
                return f'{mangled[end - n:end]}<{m.group(1)}>'
    return mangled


def sass_counts(library: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function of a built library, how many of its SASS
    instructions are wgmma (``HGMMA``) and TMA loads (``UTMALDG``), from
    ``cuobjdump -sass``."""
    proc = subprocess.run([_toolkit_bin('cuobjdump'), '-sass', library],
                          capture_output=True, text=True, check=True)
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in proc.stdout.splitlines():
        head = re.match(r'\s*Function\s*:\s*(\S+)', line)
        if head:
            current = counts.setdefault(short_name(head.group(1)),
                                        {op: 0 for op in SASS_OPS})
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf'\b{op}\b', line):
                    current[op] += 1
    return counts


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function, the registers and spill bytes that
    ``-Xptxas -v`` reported in an nvcc log."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
        regs = re.search(r'Used (\d+) registers', line)
        if head:
            current = report.setdefault(short_name(head.group(1)), {})
        elif current is not None and spill:
            current['spill_stores'] = int(spill.group(1))
            current['spill_loads'] = int(spill.group(2))
        elif current is not None and regs:
            current['registers'] = int(regs.group(1))
    return report
