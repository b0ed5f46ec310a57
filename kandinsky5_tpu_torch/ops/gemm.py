"""The shared wgmma GEMM's plain-GEMM entries (``csrc/gemm_i8.cu`` on
``csrc/gemm_sm90.cuh``): C = A (M, K) . B (N, K)^T for the tools' T1 (int8
and bf16) and T2 (bf16 out). Their shape rules are the GEMM's own."""

from __future__ import annotations

import torch

from kandinsky5_tpu_torch.ops import _kernels

# kernel -> (C entry, out dtype)
ENTRIES = {"T1_gemm_i8": ("k5_gemm_i8", torch.int32),
           "T1_gemm_bf16": ("k5_gemm_bf16", torch.float32),
           "T2_gemm": ("k5_gemm_bf16_out", torch.bfloat16)}


def launch_gemm(name, a, b, dtype):
    """C = a (M, K) . b (N, K)^T by kernel ``name`` (a key of ENTRIES) on
    CUDA tensors of ``dtype``, under the shared GEMM's rules: any M, N a
    multiple of 8, K times the element size a multiple of 16, contiguous
    16-byte-aligned operands; raises otherwise."""
    _kernels.refuse_grad(name, a, b)
    entry, out_dtype = ENTRIES[name]
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{name} takes {dtype} operands, got {a.dtype} "
                         f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{name} shapes: a {tuple(a.shape)} b "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[0]
    if n % 8 or (k * a.element_size()) % 16 or k == 0:
        raise ValueError(f"{name}: N ({n}) must be a multiple of 8 and K "
                         f"({k}) of {16 // a.element_size()}")
    _kernels.check_cuda(name, a=a, b=b)
    _kernels.check_tma_aligned(name, a=a, b=b)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _kernels.launch(entry, name, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    m, n, k)
    return out
