"""Build ``imagefolder_tpu_torch/csrc/*.cu`` into one shared library and load it.

The library has a plain C interface and is bound with ``ctypes`` (no PyTorch
headers, so nvcc takes seconds, not minutes). It is built at the first CUDA
call, from the sources in the package only, into ``imagefolder_tpu_torch/_build/``
under a name keyed by a hash of the sources and the flags; a later process
with the same sources loads it without building. Each ``.cu`` compiles in an
nvcc process of its own, all started together, and one more links them.
ptxas's report of each kernel's registers, shared memory and spills, and
each source's compile time, are kept beside the library (``ptxas_report``,
``compile_seconds``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "compile_seconds", "load_library", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# compile flags of every source; -Xptxas -v reports registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD / f"libimagefolder_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        objs.append(_BUILD / f"{tag}.{src.stem}.o")
        cmds.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(objs[-1])])
    tmp = _BUILD / f"{tag}.so.tmp"
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        # one reader thread a process, so that a full pipe never stalls an
        # nvcc, and each source's wall time from the common start
        outputs, seconds = [""] * len(procs), [0.0] * len(procs)

        def wait(i: int):
            outputs[i] = procs[i].communicate()[0]
            seconds[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
        for t in threads:
            t.start()
        for t in threads:  # wait for every one
            t.join()
        failed = [(cmd, proc.returncode, output)
                  for cmd, proc, output in zip(cmds, procs, outputs) if proc.returncode]
        if failed:  # every failing source's report, not only the first
            raise RuntimeError("\n".join(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{output}"
                                          for cmd, rc, output in failed))
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        _finish(link, done.stdout + done.stderr, done.returncode)
        out.with_suffix(".ptxas.txt").write_text("".join(outputs))
        out.with_suffix(".seconds.txt").write_text("".join(
            f"{Path(c[c.index('-c') + 1]).name} {t:.1f}\n" for c, t in zip(cmds, seconds)))
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def _finish(cmd: list[str], output: str, returncode: int):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")


def _kernel_name(mangled: str) -> str:
    """The kernel's own name (the length-prefixed identifier that ends in
    ``_kernel``) and its bool and int template arguments, e.g.
    ``attn_bnhd_bf16_kernel<true, false>``. The last such identifier is
    taken: an anonymous namespace's name, which holds the source's name,
    comes before it."""
    for m in reversed(list(re.finditer(r"(?=(\d+))", mangled))):
        n = m.group(1)
        ident = mangled[m.start() + len(n):m.start() + len(n) + int(n)]
        if ident.endswith("_kernel") and ident.isidentifier():
            rest = mangled[m.start() + len(n) + len(ident):]
            targs = re.match(r"I((?:L[bi]\d+E)+)E", rest)
            if not targs:
                return ident
            args = [{"b0": "false", "b1": "true"}.get(t, t[1:])
                    for t in re.findall(r"L([bi]\d+)E", targs.group(1))]
            return f"{ident}<{', '.join(args)}>"
    return mangled


def compile_seconds() -> list[str]:
    """Each source's nvcc wall time in seconds from the build's common
    start ("name seconds"), slowest first; empty if this process found the
    library already built."""
    path = library_path().with_suffix(".seconds.txt")
    if not path.exists():
        return []
    rows = [line.split() for line in path.read_text().splitlines() if line]
    return [f"{n} {t}" for n, t in sorted(rows, key=lambda r: -float(r[1]))]


def ptxas_report() -> list[str]:
    """One line per compiled kernel of the built library: its name, then
    ptxas's registers, shared memory and spills. Empty if this process found
    the library already built, with no report beside it."""
    path = library_path().with_suffix(".ptxas.txt")
    if not path.exists():
        return []
    report, name = {}, None
    for line in path.read_text().splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
            report[name] = []
        elif name and ("Used" in line or "spill" in line):
            report[name].append(line.split(":", 1)[-1].strip())
    return [f"{k}: {'; '.join(v)}" for k, v in report.items()]


@functools.cache
def load_library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))
