"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `.cu` source under `csrc/` becomes one shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into
`mocodad_tpu_torch/build/` and rebuilt when the hash of the source and of
the headers under `csrc/` changes.
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
from typing import Dict, Iterable, List

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
    of the source and of every header under `csrc/` (the sources share
    one), so an edited source or header gets a fresh build."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith('.cuh'))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{h.hexdigest()[:16]}.so')


# nvcc's output for each source this process built (with `verbose`,
# ptxas's registers and spills per kernel)
LOGS: Dict[str, str] = {}


def build_all(sources: Iterable[str], verbose: bool = False) -> List[str]:
    """Compile every `csrc/<source>` whose build does not exist, one nvcc
    per source, all started together; returns the paths.  Raises
    RuntimeError, with nvcc's output, if an nvcc fails."""
    sources = list(sources)
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for source, out in todo:
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, source)]
        if verbose:
            cmd.insert(1, '-Xptxas=-v')
        running.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for (source, _), (cmd, tmp, out, proc) in zip(todo, running):
        log, _ = proc.communicate()
        LOGS[source] = log
        if proc.returncode != 0:
            failed.append(f'{" ".join(cmd)}\n{log}')
            continue
        if verbose:
            print(log, end='', flush=True)
            print(f'built {os.path.basename(out)} '
                  f'({time.perf_counter() - t0:.1f} s since the start)',
                  flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return outs


def build(source: str, verbose: bool = False) -> str:
    """Compile `csrc/<source>` unless its build exists; returns the path."""
    return build_all([source], verbose)[0]


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source: str) -> ctypes.CDLL:
    """Build if needed and load `csrc/<source>` (one handle per process)."""
    path = build(source)
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(path)
    return _LOADED[path]
