"""Build the CUDA sources under ``repro_torch/csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``<repo>/build/repro_torch/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The hash covers the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.  All sources compile in
parallel (one ``nvcc`` process each) the first time any kernel is launched,
never at import: importing the package needs no ``nvcc``.  The compiler's
output is kept beside each library as ``<name>-<hash>.log``.

Each source exports plain C functions that take device pointers, sizes and
the CUDA stream, launch on that stream and return ``cudaGetLastError()``;
``<name>_error_string`` turns a code into its message.
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
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{h[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel, and
    load them.  Returns the wall seconds spent.  Raises on a failed build."""
    t0 = time.perf_counter()
    todo = [s for s in sources() if s.stem not in _LIBS]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        procs.append((src, out, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{src.name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for src in todo:
        _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
    return time.perf_counter() - t0


def ptxas_report() -> List[dict]:
    """Registers and spill bytes of every kernel of every built source, from
    the ``-Xptxas -v`` lines of the build logs (mangled kernel names)."""
    out = []
    for src in sources():
        log = _target(src).with_suffix(".log")
        if not log.exists():
            continue
        fn = None
        spill = (0, 0)
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out.append({"source": src.name, "kernel": fn, "registers": int(m.group(1)),
                            "spill_stores": spill[0], "spill_loads": spill[1]})
                fn = None
    return out


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def parse_sass(text: str, opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -sass`` text -> {function: {opcode: count}}: each
    instruction counts under its opcode's stem (``HGMMA.64x256x16.F32``
    counts as ``HGMMA``), a predicate guard aside."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(opcodes, 0)
            continue
        m = _SASS_OPCODE.search(line)
        if m and fn is not None and m.group(1) in out[fn]:
            out[fn][m.group(1)] += 1
    return out


def sass_opcodes(lib: str, opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """The machine code of the built library ``lib`` (its kernels' SASS, by
    ``cuobjdump`` beside ``nvcc``): per kernel, how many instructions of
    each of ``opcodes`` it holds."""
    build_all()
    src = next(s for s in sources() if s.stem == lib)
    tool = str(Path(_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(_target(src))], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return parse_sass(text, opcodes)


def function(lib: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C function of library ``lib`` with its argument types declared
    (pointers and the stream as ``c_void_p``, sizes as ``c_int``)."""
    fn = _FUNCS.get((lib, name))
    if fn is None:
        if lib not in _LIBS:
            build_all()
        fn = getattr(_LIBS[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(lib, name)] = fn
    return fn


def check(lib: str, err: int) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        msg = getattr(_LIBS[lib], f"{lib}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {err} "
                           f"({msg(err).decode()})")
