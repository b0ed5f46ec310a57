"""T2-T4: the JAX package's GEMM and fused-FF probes on this card.

Port of ``tools/bench_pallas_gemm.py``. Its three Pallas kernels are the
kernels replaced here, each beside its plain version and one PyTorch call:

  * T2 ``_gemm_kernel``: y = bf16(x . W), fp32 accumulation, at the DiT's
    serial out-projection shape (47616, 1792) x (1792, 1792). The port's
    kernel is the shared wgmma GEMM (``csrc/gemm_sm90.cuh``, entry in
    ``csrc/gemm_i8.cu``) with a bf16 epilogue; library call: bf16
    ``torch.matmul``.
  * T3 ``_ff_kernel``: the untiled fused FF, gelu_erf(x . W1) -> bf16, then
    . W2 in one fp32 sum, bf16 out. The TPU kernel keeps both weights
    resident (51.4 MB of VMEM); 227 KB of shared memory cannot, so the port
    runs K8's entry (``csrc/ff_mod.cu`` ``ff_gemm<2>`` and ``<3>``): the up
    product streams W1's 256 x 64 tiles through a TMA ring in shared memory
    and writes the bf16 hidden to device memory, the down product streams
    W2's tiles the same way and keeps its fp32 sum in registers.
  * T4 ``_ff_tiled_kernel``: the ff-chunked fused FF (K8's ancestor, the
    same math) at bf 1024: per chunk, the (rows, 1024) hidden, then its down
    product added to an fp32 accumulator in device memory
    (``k5_ff_chunked``: ``ff_gemm<2>`` and ``<4>``). The TPU row tile bs
    (256) sets VMEM blocks and has no counterpart: the GEMMs here take
    128-row tiles.

The library call for T3 and T4 is ``matmul`` -> ``F.gelu`` -> ``matmul`` in
bf16 (its hidden is rounded before the GELU as well). Weights are in the
torch (out, in) layout; the JAX tool's are their transposes.

    python -m kandinsky5_tpu_torch.tools.bench_pallas_gemm [--split]

prints, per case, the kernel's and the library call's times and TFLOP/s,
the error against the plain version and the card's name and power limit.
``--split`` also times T4's kernels apart: its 7 up kernels, its 7 down
kernels, and the same down products without the fp32 accumulator (K8's
down kernel on each chunk). Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.ff import _ff_operands, ff_plain, launch_ff
from kandinsky5_tpu_torch.ops.gemm import launch_gemm

# the JAX tool's shapes: model width, FF width, tokens (5 s, 47,616)
D, FF, S = 1792, 7168, 47616
T4_BF = 1024


def gemm_plain(x, w):
    """Plain T2: the fp32 product of the bf16 values, rounded once."""
    return (x.float() @ w.float().T).to(x.dtype)


def gemm(x, w):
    """T2 wrapper: x (M, K) . w (N, K)^T -> (M, N) bf16; any M, N a multiple
    of 8, K of 8. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    _kernels.refuse_grad("T2", x, w)
    if x.device.type == "cpu":
        return gemm_plain(x, w)
    return launch_gemm("T2_gemm", x, w, torch.bfloat16)


def ff(x, w1, w2):
    """T3 wrapper: K8's entry, counted as T3. A CPU tensor takes the plain
    version (K8's)."""
    _kernels.refuse_grad("T3", x, w1, w2)
    if x.device.type == "cpu":
        return ff_plain(x, w1, w2)
    return launch_ff(x, w1, w2, counter="T3_ff")


def ff_chunked_plain(x, w1, w2, bf: int = T4_BF):
    """Plain T4: per ff chunk the bf16 hidden and its fp32 down product,
    summed chunk by chunk in fp32, rounded once."""
    acc = None
    for j in range(0, w1.shape[0], bf):
        h = F.gelu(x.float() @ w1[j:j + bf].float().T,
                   approximate="none").to(x.dtype)
        part = h.float() @ w2[:, j:j + bf].float().T
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


# T4's kernels (``k5_ff_chunked``'s parts): the up kernels, the down
# kernels with the fp32 accumulator, the down kernels without it
T4_UP, T4_DOWN, T4_DOWN_NO_ACC = 1, 2, 4


def ff_chunked(x, w1, w2, bf: int = T4_BF, parts: int = T4_UP | T4_DOWN):
    """T4 wrapper: x (M, D), w1 (FF, D), w2 (D, FF) bf16; FF a multiple of
    bf and bf of 128. A CPU tensor takes the plain version. ``parts``
    other than T4_UP | T4_DOWN launches only some of the kernels, for a
    timing split; the output is then not T4's."""
    _kernels.refuse_grad("T4", x, w1, w2)
    if x.device.type == "cpu":
        return ff_chunked_plain(x, w1, w2, bf)
    x2 = _ff_operands("T4", x, w1, w2)
    rows, d = x2.shape
    ff_dim = w1.shape[0]
    if bf % 128 or ff_dim % bf:
        raise ValueError(f"T4: ff {ff_dim} is not a multiple of bf {bf} "
                         "(a multiple of 128)")
    hidden = torch.empty((rows, bf), dtype=x.dtype, device=x.device)
    acc = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    _kernels.launch("k5_ff_chunked", "T4_ff_tiled", x2.data_ptr(),
                    w1.data_ptr(), w2.data_ptr(), hidden.data_ptr(),
                    acc.data_ptr(), out.data_ptr(), rows, d, ff_dim, bf, parts)
    return out.reshape(x.shape)


def gemm_library(x, w):
    """The one PyTorch call computing T2's function: bf16 matmul."""
    wt = w.t()
    return lambda: torch.matmul(x, wt)


def ff_library(x, w1, w2):
    """T3's and T4's yardstick: matmul -> GELU -> matmul in bf16."""
    w1t, w2t = w1.t(), w2.t()
    return lambda: torch.matmul(F.gelu(torch.matmul(x, w1t)), w2t)


def operands(generator, device, rows: int = S):
    """Seeded bf16 x (rows, D) ~ N(0, 1) and weights scaled so each product
    is of order one: wo (D, D), w1 (FF, D), w2 (D, FF)."""
    def draw(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * fan_in ** -0.5).bfloat16()

    x = torch.randn((rows, D), generator=generator, device=device).bfloat16()
    return x, draw((D, D), D), draw((FF, D), D), draw((D, FF), FF)


def cases(x, wo, w1, w2):
    """(name, kernel, plain, library call, bf16 FLOPs, control) of T2, T3
    and T4. The control is the plain version with one tile of the reduction
    left out (the last 64 of T2's K, one 128-byte k step; the last 128
    hidden units of the FFs): a check must tell it from the kernel."""
    rows = x.shape[0]
    return (
        ("T2_gemm", lambda: gemm(x, wo), lambda: gemm_plain(x, wo),
         gemm_library(x, wo), 2.0 * rows * D * D,
         lambda: gemm_plain(x[:, :-64], wo[:, :-64])),
        ("T3_ff", lambda: ff(x, w1, w2), lambda: ff_plain(x, w1, w2),
         ff_library(x, w1, w2), 4.0 * rows * D * FF,
         lambda: ff_plain(x, w1[:-128], w2[:, :-128])),
        ("T4_ff_tiled", lambda: ff_chunked(x, w1, w2),
         lambda: ff_chunked_plain(x, w1, w2), ff_library(x, w1, w2),
         4.0 * rows * D * FF,
         lambda: ff_chunked_plain(x, w1[:-128], w2[:, :-128])),
    )


def main() -> None:
    from kandinsky5_tpu_torch.tools import gpu_line
    from kandinsky5_tpu_torch.tools.bench_int8mm import time_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="also time T4's up and down kernels apart")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x, wo, w1, w2 = operands(g, dev)
    for name, kernel, plain, library, flops, _ in cases(x, wo, w1, w2):
        out, ref = kernel(), plain()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        del out, ref
        t = time_ms(kernel)
        t_lib = time_ms(library)
        print(f"  {name} ({S},{D})x{FF if name != 'T2_gemm' else D}: kernel "
              f"{t:8.3f} ms {flops / t / 1e9:6.1f} TFLOP/s | library "
              f"{t_lib:8.3f} ms {flops / t_lib / 1e9:6.1f} TFLOP/s | max abs "
              f"error {err:.3e} (largest output {scale:.3e})", flush=True)
    if args.split:
        half = 2.0 * S * D * FF
        for label, parts in (("up kernels (mode 2)", T4_UP),
                             ("down kernels (mode 4, fp32 accumulator)",
                              T4_DOWN),
                             ("down kernels without the accumulator (mode 3)",
                              T4_DOWN_NO_ACC),
                             ("all (T4)", T4_UP | T4_DOWN)):
            t = time_ms(lambda p=parts: ff_chunked(x, w1, w2, parts=p))
            flops = 2 * half if parts == T4_UP | T4_DOWN else half
            print(f"  T4 split, {FF // T4_BF} chunks of {T4_BF}: {label} "
                  f"{t:8.3f} ms {flops / t / 1e9:6.1f} TFLOP/s", flush=True)
    print(gpu_line())


if __name__ == "__main__":
    main()
