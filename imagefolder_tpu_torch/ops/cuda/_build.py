"""Build ``imagefolder_tpu_torch/csrc/*.cu`` into one shared library and load it.

The library has a plain C interface and is bound with ``ctypes`` (no PyTorch
headers, so nvcc takes seconds, not minutes). It is built at the first CUDA
call, from the sources in the package only, into ``imagefolder_tpu_torch/_build/``
under a name keyed by a hash of the sources and the flags; a later process
with the same sources loads it without building. Each ``.cu`` compiles in an
nvcc process of its own, all started together, and one more links them.
ptxas's report of each kernel's registers, shared memory and spills is kept
beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load_library", "ptxas_report"]

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
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outputs = [proc.communicate()[0] for proc in procs]  # wait for every one
        for cmd, proc, output in zip(cmds, procs, outputs):
            _finish(cmd, output, proc.returncode)
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        _finish(link, done.stdout + done.stderr, done.returncode)
        out.with_suffix(".ptxas.txt").write_text("".join(outputs))
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
    ``attn_bnhd_bf16_kernel<true, false>``."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        n = m.group(1)
        ident = mangled[m.start() + len(n):m.start() + len(n) + int(n)]
        if ident.endswith("_kernel"):
            rest = mangled[m.start() + len(n) + len(ident):]
            targs = re.match(r"I((?:L[bi]\d+E)+)E", rest)
            if not targs:
                return ident
            args = [{"b0": "false", "b1": "true"}.get(t, t[1:])
                    for t in re.findall(r"L([bi]\d+)E", targs.group(1))]
            return f"{ident}<{', '.join(args)}>"
    return mangled


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
