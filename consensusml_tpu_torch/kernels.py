"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``consensusml_tpu_torch/build/`` (listed in
``.gitignore``), then loaded with :mod:`ctypes`. The library's file name
carries a hash of its source and flags, so an edited source rebuilds
and a stale library is never loaded. :func:`build` starts one ``nvcc``
per missing source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.

Launch counts live on each kernel's wrapper as a plain integer
(``wrapper.launches``); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them. A wrapper whose kernel has
forms also counts the launches of each (``wrapper.<form>_launches``:
``chunk_scatter.acc_launches``, its accumulating form; the flash
kernels' ``masked_launches``, their ``kv_mask`` form,
``d128_launches``, their head-dim-128 form, and ``offset_launches``,
their q/k offset form), which :func:`form_counts` reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = [
    "KERNELS",
    "SOURCES",
    "BUILD_DIR",
    "build",
    "load",
    "launch_counts",
    "form_counts",
    "reset_launch_counts",
]

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# kernel name -> (module, wrapper attribute, source): the source is
# csrc/<source>.cu; one source may hold several kernels (the flash
# backward's dq and dk/dv, the three fused-BN kernels, the int8, fp8 and
# int4 codecs' two directions, the LayerNorm's forward and backward)
KERNELS = {
    "paged_attention": (
        "consensusml_tpu_torch.models.paged_attention", "paged_attention", "paged_attention"
    ),
    "flash_attention_fwd": (
        "consensusml_tpu_torch.models.flash_attention", "flash_attention", "flash_attention_fwd"
    ),
    "flash_attention_bwd_dq": (
        "consensusml_tpu_torch.models.flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd",
    ),
    "flash_attention_bwd_dkv": (
        "consensusml_tpu_torch.models.flash_attention", "flash_attention_bwd_dkv",
        "flash_attention_bwd",
    ),
    "fused_choco_encode": (
        "consensusml_tpu_torch.compress.kernels", "fused_pack_quantize", "fused_choco_encode"
    ),
    "fused_dequantize_accumulate": (
        "consensusml_tpu_torch.compress.kernels", "fused_dequantize_accumulate", "fused_choco_decode"
    ),
    "quantize_int8": ("consensusml_tpu_torch.compress.kernels", "quantize_int8", "int8_codec"),
    "dequantize_int8": ("consensusml_tpu_torch.compress.kernels", "dequantize_int8", "int8_codec"),
    "quantize_fp8": ("consensusml_tpu_torch.compress.kernels", "quantize_fp8", "int8_codec"),
    "dequantize_fp8": ("consensusml_tpu_torch.compress.kernels", "dequantize_fp8", "int8_codec"),
    "quantize_int4": ("consensusml_tpu_torch.compress.kernels", "quantize_int4", "int4_codec"),
    "dequantize_int4": ("consensusml_tpu_torch.compress.kernels", "dequantize_int4", "int4_codec"),
    "chunked_topk": ("consensusml_tpu_torch.compress.kernels", "chunked_topk", "chunked_topk"),
    "chunk_scatter": ("consensusml_tpu_torch.compress.kernels", "chunk_scatter", "chunk_scatter"),
    "bn_stats": ("consensusml_tpu_torch.models.fused_bn", "bn_stats", "fused_bn"),
    "bn_norm": ("consensusml_tpu_torch.models.fused_bn", "bn_norm", "fused_bn"),
    "bn_bwd": ("consensusml_tpu_torch.models.fused_bn", "bn_bwd", "fused_bn"),
    "ln_fwd": ("consensusml_tpu_torch.models.fused_ln", "ln_fwd", "fused_ln"),
    "ln_bwd": ("consensusml_tpu_torch.models.fused_ln", "ln_bwd", "fused_ln"),
}
SOURCES = tuple(dict.fromkeys(src for _m, _a, src in KERNELS.values()))

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels are built from source at first use"
        )
    return path


def _lib_path(name: str) -> Path:
    # every header of csrc/ goes into the hash, so an edited shared header
    # rebuilds the sources that include it
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source (``csrc/<name>.cu``) whose library is
    missing, one ``nvcc`` per source, all started together. Returns per
    source ``{"seconds", "cached", "ptxas"}`` (``ptxas`` = the
    register/spill report lines). Raises with the compiler's output when
    a build fails."""
    with _lock:
        return _build_locked(list(names))


def _build_locked(names: list[str]) -> dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r} (one of {list(SOURCES)})")
        lib = _lib_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"seconds": 0.0, "cached": True, "ptxas": _ptxas(log)}
            continue
        # write to a private name, then rename: a concurrent process never
        # sees a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            time.perf_counter(), tmp, lib, log,
        )
    failed = []
    for name, (proc, t0, tmp, lib, log) in procs.items():
        text, _ = proc.communicate()
        text = text.decode(errors="replace")
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, lib)
        out[name] = {
            "seconds": time.perf_counter() - t0, "cached": False,
            "ptxas": _ptxas(log),
        }
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def _ptxas(log: Path) -> list[str]:
    if not log.exists():
        return []
    return [
        ln.split(":", 1)[-1].strip() if "ptxas info" in ln else ln.strip()
        for ln in log.read_text().splitlines()
        if "ptxas info    : Used" in ln or "spill stores" in ln
    ]


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build_locked([name])
            lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def _wrappers():
    for name, (module, attr, _src) in KERNELS.items():
        yield name, getattr(importlib.import_module(module), attr)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per kernel."""
    return {name: fn.launches for name, fn in _wrappers()}


def _forms(fn) -> list[str]:
    return [a for a in vars(fn) if a.endswith("_launches")]


def form_counts() -> dict[str, dict[str, int]]:
    """Launches since the last reset of each form of a kernel with forms,
    e.g. ``{"chunk_scatter": {"acc": n}}``."""
    return {name: {a[: -len("_launches")]: getattr(fn, a) for a in _forms(fn)}
            for name, fn in _wrappers() if _forms(fn)}


def reset_launch_counts() -> None:
    for _name, fn in _wrappers():
        fn.launches = 0
        for attr in _forms(fn):
            setattr(fn, attr, 0)
