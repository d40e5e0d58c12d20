"""The kernels' build (``skypilot_tpu_torch/ops/_build.py``) on the CPU.

The library of a kernel is named by a hash of its source, of every
shared header in its source directory and of the nvcc flags, so that an
edited header or flag never loads a stale library. The reports the build
phase of ``chip_smoke.py`` prints (registers and spills from ``-Xptxas
-v``, wgmma and TMA instruction counts from ``cuobjdump -sass``) are
parsed from the tools' text, checked here on samples of it.
"""
import os
import shutil
import stat

import pytest

from skypilot_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc/ to edit."""
    path = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC_DIR, path)
    return str(path)


def _path(csrc):
    return _build.library_path('flash_fwd', csrc_dir=csrc,
                               build_dir='/build')


def test_the_kernels_include_the_shared_header():
    for name in ('flash_fwd', 'flash_bwd'):
        with open(os.path.join(_build.CSRC_DIR, f'{name}.cu')) as f:
            assert '#include "sm90.cuh"' in f.read()


@pytest.mark.parametrize('edit', ['header', 'source', 'new_header'])
def test_library_path_follows_source_and_headers(csrc, edit):
    before = _path(csrc)
    target = {'header': 'sm90.cuh', 'source': 'flash_fwd.cu',
              'new_header': 'extra.cuh'}[edit]
    with open(os.path.join(csrc, target), 'a') as f:
        f.write('\n// edited\n')
    assert _path(csrc) != before


@pytest.mark.parametrize('change', ['added', 'dropped'])
def test_library_path_follows_the_flags(csrc, monkeypatch, change):
    before = _path(csrc)
    flags = _build.NVCC_FLAGS
    monkeypatch.setattr(_build, 'NVCC_FLAGS', flags + ('-lineinfo',)
                        if change == 'added' else flags[:-2])
    assert _path(csrc) != before


def test_library_path_ignores_what_is_not_compiled(csrc):
    before = _path(csrc)
    os.utime(os.path.join(csrc, 'sm90.cuh'), (0, 0))  # content unchanged
    with open(os.path.join(csrc, 'NOTES.txt'), 'w') as f:
        f.write('not a header')
    # Another kernel's source is not part of this kernel's build.
    with open(os.path.join(csrc, 'flash_bwd.cu'), 'a') as f:
        f.write('\n// edited\n')
    assert _path(csrc) == before
    assert _path(csrc).startswith('/build/libflash_fwd_')


def test_without_a_toolkit_the_build_says_where_nvcc_goes(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(shutil, 'which', lambda tool: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.find_nvcc()


MANGLED = {
    '_ZN45_GLOBAL__N__5cadf60c_12_flash_fwd_cu_e9339fcc16flash_fwd_kernel'
    'ILi128EEEvNS_6ParamsE': 'flash_fwd_kernel<128>',
    # The hash before the name's length ends in digits.
    '_ZN45_GLOBAL__N__c73cb41a_12_flash_bwd_cu_6d79913621flash_bwd_dkdv_'
    'kernelILi64EEEvNS_6ParamsE': 'flash_bwd_dkdv_kernel<64>',
    # An earlier digit run ('48') that would also fit a longer name.
    '_ZN45_GLOBAL__N__abcd48e8_12_flash_bwd_cu_6d79913619flash_bwd_dq_'
    'kernelILi128EEEvNS_6ParamsE': 'flash_bwd_dq_kernel<128>',
    'plain_c_function': 'plain_c_function',
}


@pytest.mark.parametrize('mangled,short', MANGLED.items())
def test_short_names_of_kernel_instances(mangled, short):
    assert _build.short_name(mangled) == short


PTXAS_LOG = """\
ptxas info    : (C7519) warpgroup.arrive is injected in around line 5698
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c73cb41a_12_\
flash_bwd_cu_6d79913619flash_bwd_dq_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__c73cb41a_12_flash\
_bwd_cu_6d79913619flash_bwd_dq_kernelILi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__c73cb41a_12_\
flash_bwd_cu_6d79913622flash_bwd_delta_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 28 registers, used 0 barriers
"""


def test_ptxas_report_reads_registers_and_spills():
    assert _build.ptxas_report(PTXAS_LOG) == {
        'flash_bwd_dq_kernel<128>': {'spill_stores': 0, 'spill_loads': 0,
                                     'registers': 168},
        'flash_bwd_delta_kernel<64>': {'spill_stores': 4, 'spill_loads': 12,
                                       'registers': 28}}


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN45_GLOBAL__N__5cadf60c_12_flash_fwd_cu_e9339fcc16flash_fwd\
_kernelILi128EEEvNS_6ParamsE
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR16], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR8] ;
\t\tFunction : _ZN45_GLOBAL__N__c73cb41a_12_flash_bwd_cu_6d79913622flash_bwd\
_delta_kernelILi64EEEvNS_6ParamsE
        /*0100*/                   FFMA R3, R4, R5, R3 ;
"""


def test_sass_counts_read_cuobjdump(monkeypatch, tmp_path):
    sample = tmp_path / 'sass.txt'
    sample.write_text(SASS)
    tool = tmp_path / 'cuobjdump'
    tool.write_text(f'#!/bin/sh\ncat {sample}\n')
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, '_toolkit_bin', lambda name: str(tool))
    assert _build.sass_counts('lib.so') == {
        'flash_fwd_kernel<128>': {'HGMMA': 2, 'UTMALDG': 2},
        'flash_bwd_delta_kernel<64>': {'HGMMA': 0, 'UTMALDG': 0}}
