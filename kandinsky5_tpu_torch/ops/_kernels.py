"""Build, load and count the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a``, one process per source
running in parallel, and link into one shared library with a plain C
interface, loaded through ``ctypes``; no PyTorch header is compiled, so a
build takes seconds. The library lands in
``kandinsky5_tpu_torch/_build/<source hash>/`` at first use and is rebuilt
whenever a source changes. Nothing here runs at import time: the CPU tests
import every module of the port on a machine with no CUDA toolkit.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES`; a run reads the counts to show which kernels its main
path went through.

No kernel has a backward rule, as no ``pallas_call`` of the JAX package
has one. A launch through ``ctypes`` is invisible to autograd, so every
public kernel entry calls :func:`refuse_grad` first, on the CPU (where it
would take the differentiable plain version) as on the card: a kernel under
autograd raises instead of returning a detached result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"K1_flash_fixed": 0, "K2_ff_mod": 0, "K2_modulate": 0,
            "K3_conv3d": 0, "K3_conv3d_fused": 0, "K3_conv3d_quant": 0,
            "K3_quant_windows": 0, "K4_flash_online": 0, "K5_flash_int8": 0,
            "K6_sparse_nabla": 0, "K7_flash_int8_pipe": 0, "K8_ff": 0,
            "T1_gemm_i8": 0, "T1_gemm_bf16": 0, "T2_gemm": 0, "T3_ff": 0,
            "T4_ff_tiled": 0, "T5_i8_decomp": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "k5_flash_fixed": [_P] * 6 + [_I] * 4 + [_P],
    "k5_flash_online": [_P] * 8 + [_I] * 4 + [_P],
    "k5_ff_mod": [_P] * 8 + [_I] * 4 + [_P],
    "k5_ff_modulate": [_P] * 4 + [_I] * 3 + [_P],
    "k5_ff": [_P] * 5 + [_I] * 3 + [_P],
    "k5_ff_chunked": [_P] * 6 + [_I] * 5 + [_P],
    "k5_conv3d": [_P] * 4 + [_I] * 6 + [_P],
    "k5_conv3d_fused": [_P] * 6 + [_I] * 8 + [_P],
    "k5_conv3d_window_scale": [_P] * 6 + [_I] * 9 + [_P],
    "k5_conv3d_quant": [_P] * 9 + [_I] * 10 + [_P],
    "k5_sparse_nabla": [_P] * 8 + [_I] * 4 + [_P],
    "k5_flash_int8": [_P] * 7 + [_I] * 4 + [_P],
    "k5_flash_int8_pipe": [_P] * 7 + [_I] * 4 + [_P],
    "k5_i8_decomp": [_P] * 6 + [_I] * 5 + [_P],
    "k5_gemm_i8": [_P] * 3 + [_I] * 3 + [_P],
    "k5_gemm_bf16": [_P] * 3 + [_I] * 3 + [_P],
    "k5_gemm_bf16_out": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record ``tensors`` going through kernel
    ``name``: grad mode is on and an operand requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an operand requires grad. The JAX "
            "package cannot differentiate its Pallas counterpart either. "
            "Train on the routes that run no kernel: attn_impl=\"dense\", "
            "and fp32 parameters or FF shapes that ff_supported refuses.")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(ARCH.encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the hashed build directory (if not already
    there) and return the library path: one ``nvcc -c`` per source, all
    started together, then one link. ``BUILD_INFO`` records the seconds
    taken and the ptxas resource report (registers, shared memory,
    spills) of the build that ran."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib = os.path.join(out_dir, "libk5kernels.so")
    if os.path.exists(lib) and not force:
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = str(os.getpid())
    nvcc = _nvcc()
    compile_cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-lineinfo", "-c"]
    t0 = time.time()
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = compile_cmd + [src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, errors = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
    objs = [obj for _, obj, _ in jobs]
    tmp = f"{lib}.{tag}.tmp"
    link_cmd = [nvcc, ARCH, "-shared", "-o", tmp] + objs
    if not errors:
        res = subprocess.run(link_cmd, capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    BUILD_INFO.update(seconds=time.time() - t0, log="".join(log),
                      cmd=" ".join(compile_cmd + ["<source>"]) + " && "
                      + " ".join(link_cmd))
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call C entry ``name`` on the current CUDA stream (appended as the
    last argument), raise on a launch error, and count the launch."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor."""
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def check_tma_aligned(name: str, **tensors) -> None:
    """Raise unless every given tensor's base address is 16-byte aligned,
    as a TMA tensor map over it needs."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned (its TMA "
                             "tensor map needs it)")
