"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/`` at
the repository root (a name that carries a hash of the source and of the
``csrc/*.cuh`` headers it includes, so an edited source or header is
rebuilt).  All sources are compiled at once, one ``nvcc`` process
each, started together.  The libraries are loaded with :mod:`ctypes`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("pareto_rank.cu", "window_attn.cu", "ssd_scan.cu",
           "quant_matmul.cu", "fake_quant.cu", "mbconv_dw.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _headers(source: str, csrc: Path = CSRC) -> List[Path]:
    """The headers of ``csrc`` that ``source`` includes with quotes,
    directly or through another such header, sorted."""
    found: List[Path] = []
    todo = [csrc / source]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = csrc / name
            if path not in found:
                found.append(path)
                todo.append(path)
    return sorted(found)


def _target(source: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in _headers(source, csrc):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns source name -> library path.  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in SOURCES}
    procs = {}
    for src, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def _cuobjdump() -> Optional[str]:
    nvcc = Path(_nvcc())
    tool = nvcc.with_name("cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def _kernel_name(mangled: str) -> str:
    """``window_attn_kernel<64>`` for the mangled name of that instance."""
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):   # overlapping
        start = m.start() + len(m.group(1))
        end = start + int(m.group(1))           # <length><identifier>
        if mangled[start:end].endswith("_kernel"):
            args = re.match(r"I((?:L\w\d+E)+)E", mangled[end:])
            values = re.findall(r"L\w(\d+)E", args.group(1)) if args else []
            return mangled[start:end] + (
                f"<{','.join(values)}>" if values else "")
    return mangled


_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def parse_sass(listing: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """Each kernel's instructions in a ``cuobjdump -sass`` listing, as
    (address, opcode without modifiers or predicate, operands)."""
    kernels: Dict[str, List[Tuple[int, str, str]]] = {}
    name = None
    for line in listing.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            kernels[name] = []
            continue
        m = _SASS_LINE.match(line)
        if name is None or m is None:
            continue
        words = m.group(2).split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            kernels[name].append((int(m.group(1), 16),
                                  words[0].split(".")[0],
                                  " ".join(words[1:])))
    return kernels


def sass(source: str) -> Optional[Dict[str, List[Tuple[int, str, str]]]]:
    """:func:`parse_sass` of ``source``'s built library; None where the
    toolkit has no ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return None
    return parse_sass(subprocess.run(
        [tool, "-sass", str(build_all()[source])], capture_output=True,
        text=True, check=True, timeout=300).stdout)


def opcode_counts(source: str, opcode: str) -> Optional[Dict[str, int]]:
    """How many ``opcode`` instructions (e.g. ``HMMA``) each kernel of
    ``source``'s built library holds, from ``cuobjdump -sass``; None where
    the toolkit has no ``cuobjdump``."""
    listing = sass(source)
    if listing is None:
        return None
    return {k: sum(op == opcode for _, op, _ in instrs)
            for k, instrs in listing.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use)."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
    return _LIBS[source]
