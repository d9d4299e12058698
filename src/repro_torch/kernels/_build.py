"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launchers (one per kernel, listed
in :data:`SIGNATURES`) and becomes its own shared library,
``build/repro_torch/<hash>/lib<name>.so`` at the repository root; the
sources may include the shared headers ``csrc/*.cuh``.  ``<hash>`` covers
the sources, the headers and the flags, so an edited kernel or header is
rebuilt and an unchanged one is reused.  All sources compile in parallel,
one ``nvcc`` process each, at the first call that needs a kernel — never at
import, so the CPU-only tests can import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MM_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
# kernel name -> (library built from csrc/<library>.cu, exported launcher,
# argtypes); every launcher returns the cudaError_t of its launch as an int.
SIGNATURES = {
    "decode_attention": ("decode_attention", "decode_attention_launch",
                         [_P] * 7 + [_I] * 7 + [_F, _P]),
    "decode_attention_layout": ("decode_attention",
                                "decode_attention_layout_check", [_I] * 6),
    "masked_matmul": ("masked_matmul", "masked_matmul_launch",
                      [_P] * 5 + [_I] * 4 + [_P]),
    "masked_matmul_decode_splits": ("masked_matmul",
                                    "masked_matmul_decode_splits", [_I] * 4),
    "masked_matmul_dx": ("masked_matmul", "masked_matmul_dx_launch",
                         [_P] * 5 + [_I] * 7 + [_P]),
    "masked_matmul_dw": ("masked_matmul", "masked_matmul_dw_launch",
                         _MM_ARGS),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P]),
    "ssd_scan": ("ssd_scan", "ssd_scan_launch", [_P] * 10 + [_I] * 10 + [_P]),
    "ssd_scan_chunk": ("ssd_scan", "ssd_scan_chunk", [_I]),
}

_lock = threading.Lock()
_loaded: dict = {}      # kernel name -> configured ctypes function
_logs: dict = {}        # library name -> nvcc/ptxas output of its build
_libs: dict = {}        # library name -> path of the built shared library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def tool(name: str) -> str:
    """Path of a CUDA toolkit program that sits beside nvcc (cuobjdump)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Build (or reuse) every kernel library and return ``{kernel name:
    launcher}``.

    Raises ``RuntimeError`` with nvcc's output when a source does not
    compile.
    """
    with _lock:
        if _loaded:
            return dict(_loaded)
        sources = sorted(CSRC.glob("*.cu"))
        out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in sources:
            lib = out_dir / f"lib{src.stem}.so"
            if lib.exists():
                log = out_dir / f"{src.stem}.log"
                if log.exists():
                    _logs[src.stem] = log.read_text()
                continue
            tmp = out_dir / f".lib{src.stem}.so.tmp-{os.getpid()}"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, lib, tmp, proc))
        failures = []
        for src, lib, tmp, proc in jobs:
            output, _ = proc.communicate()
            _logs[src.stem] = output
            (out_dir / f"{src.stem}.log").write_text(output)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed on {src.name} "
                                f"(exit {proc.returncode}):\n{output}")
            else:
                os.replace(tmp, lib)
        if failures:
            raise RuntimeError("\n".join(failures))
        _libs.update({src.stem: out_dir / f"lib{src.stem}.so" for src in sources})
        libs = {src.stem for src in sources}
        missing = libs - {lib for lib, _, _ in SIGNATURES.values()}
        if missing:
            raise RuntimeError(f"{sorted(missing)} have no entry in SIGNATURES")
        for name, (lib, symbol, argtypes) in SIGNATURES.items():
            fn = getattr(ctypes.CDLL(str(out_dir / f"lib{lib}.so")), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return dict(_loaded)


def launcher(name: str):
    """The ctypes launcher of kernel ``name`` (building at first use)."""
    fn = _loaded.get(name)
    return fn if fn is not None else build_all()[name]


def build_logs() -> dict:
    """nvcc/ptxas output of the libraries built (or reused) by this
    process."""
    return dict(_logs)


def library_paths() -> dict:
    """{library name: path} of the libraries :func:`build_all` built or
    reused in this process."""
    return dict(_libs)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once (the
    launch paths ask on every call)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
