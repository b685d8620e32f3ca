"""Build the CUDA (and plain C host) sources under csrc/ at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own with nvcc into
`build/kernels/<name>-<hash>.so` (a plain C interface; no PyTorch headers, so
a build takes seconds), where the hash covers the sources, the flags and the
nvcc path: an edited source builds anew, an unchanged one loads from disk.
Every C entry point returns `cudaGetLastError()` after its launch and
`check` turns a nonzero code into an exception: a refused launch never runs
and a later synchronise would not report it.

Flags: `sm_90a` (Hopper), -O3, and `--fmad=false` for every source. Without
it nvcc contracts a*b+c into one fused multiply-add, which rounds once where
the plain PyTorch versions (one kernel per operation) round twice. That would
move the tight-cull predicate of expand_pairs off bit-equality with its plain
version, and flip composite_fwd's and composite_bwd's alpha >= 1/255
decisions on a few pixels (each flip is a ~1e-3 image difference). No
`--use_fast_math`: `expf` and division stay IEEE-accurate, as in PyTorch.

Host libraries. `io_runtime` (plain C and pthreads, no CUDA: the IO
runtime, csrc/io_runtime.c, with the JPEG decoder csrc/jpeg_decode.c
compiled into it) builds with the C compiler named by `CC`, else `cc` or
`gcc`, at `-O2 -fPIC -shared -pthread -ffp-contract=off` (no
`-ffast-math`; no fused multiply-adds, so the resize rounds once an
operation on every host), into `build/host/<name>-<hash>.so` by the same
hash rule over every source it compiles, at first use. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("expand_pairs", "composite_fwd", "composite_bwd", "segment_ends",
           "segment_sum", "prefix_sum_small", "compact_runs", "project", "filter3d")
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_CFLAGS = ["-O2", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]
HOST_SOURCES = ("io_runtime",)
# the sources each host library compiles
HOST_UNITS = {"io_runtime": ("io_runtime", "jpeg_decode")}

_libs: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each verbose build, by source name
logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _cc() -> str:
    cand = os.environ.get("CC", "")
    if cand:
        found = shutil.which(cand)
        if found is None:
            raise RuntimeError(f"CC={cand!r} not found: the host sources cannot be built")
        return found
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError("no C compiler (CC, cc or gcc): the host sources cannot be built")


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [nvcc]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _host_sources(name: str) -> List[Path]:
    return [CSRC / f"{unit}.c" for unit in HOST_UNITS[name]]


def _host_path(name: str, cc: str) -> Path:
    h = hashlib.sha256()
    for src in _host_sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(HOST_CFLAGS + [cc]).encode())
    return HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False,
          host: Iterable[str] = HOST_SOURCES) -> Dict[str, float]:
    """Compile every named kernel source (nvcc) and host source (the C
    compiler) that has no up-to-date library, all compilers started
    together. Returns {name: seconds} of the builds run; raises with the
    compiler's output if one fails. verbose adds `-Xptxas -v` (registers,
    shared memory, spills) to the kernels' printed output."""
    jobs = []
    names, host = list(names), list(host)
    if names:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in names:
            jobs.append((name, _lib_path(name, nvcc),
                         [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])],
                         [CSRC / f"{name}.cu"], "nvcc"))
    if host:
        cc = _cc()
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in host:
            jobs.append((name, _host_path(name, cc), [cc, *HOST_CFLAGS],
                         _host_sources(name), Path(cc).name))
    procs = {}
    for name, out, cmd, srcs, tool in jobs:
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen([*cmd, "-o", str(tmp), *map(str, srcs)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter(),
                       f"{tool} failed for {', '.join(s.name for s in srcs)}")
    seconds = {}
    errors = []
    for name, (proc, tmp, out, t0, what) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{what}:\n{log}")
            continue
        if verbose and log:
            logs[name] = log
            print(f"[{name}] {log}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """{kernel symbol: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the `-Xptxas -v` report in a verbose build's log."""
    usage: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name], host=())
        lib = ctypes.CDLL(str(_lib_path(name, _nvcc())))
        lib.gsplat_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gsplat_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (HOST_UNITS: the sources it compiles),
    built first if needed."""
    key = f"host:{name}"
    lib = _libs.get(key)
    if lib is None:
        build((), host=[name])
        lib = ctypes.CDLL(str(_host_path(name, _cc())))
        _libs[key] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.gsplat_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
