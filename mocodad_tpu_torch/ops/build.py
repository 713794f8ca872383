"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under `csrc/` becomes one shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into
`mocodad_tpu_torch/build/` and rebuilt when the source's hash changes.
No PyTorch headers are involved, so a build takes seconds.  Nothing is
built at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: building the CUDA kernels needs the '
                       'CUDA toolkit (nvcc on PATH or under /usr/local/cuda)')


def library_path(source: str) -> str:
    """Where the build of `csrc/<source>` lives; the name carries the hash
    of the source, so an edited source gets a fresh build."""
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{digest}.so')


def build(source: str, verbose: bool = False) -> str:
    """Compile `csrc/<source>` unless its build exists; returns the path.
    Raises (CalledProcessError, with nvcc's output) if nvcc fails."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC_DIR, source)]
    if verbose:
        cmd.insert(1, '-Xptxas=-v')
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd,
                                            proc.stdout, proc.stderr)
    if verbose:
        print(proc.stdout + proc.stderr, end='', flush=True)
        print(f'built {os.path.basename(out)} in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    os.replace(tmp, out)
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load `csrc/<source>` (one handle per process)."""
    path = build(source)
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(path)
    return _LOADED[path]
