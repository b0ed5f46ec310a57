"""T1: does int8 pay on this card? The int8 (s8 x s8 -> s32) and bf16
(bf16 x bf16 -> f32) instances of the port's shared wgmma GEMM
(``csrc/gemm_sm90.cuh``, entries in ``csrc/gemm_i8.cu``), timed at the JAX
tool's 8192^3 and at the DiT's projection shapes, beside ``torch._int_mm``
and bf16 ``torch.matmul``.

Port of ``tools/bench_int8mm.py`` (its Pallas ``_mm_kernel`` is the kernel
replaced here). The JAX tool multiplies A (M, K) by B (K, N); here B is
(N, K), nn.Linear's (out, in) layout, so C = A . B^T.

    python -m kandinsky5_tpu_torch.tools.bench_int8mm

Each time is CUDA events over a few launches after a warm-up; the rate is
2 M N K over it. Needs a CUDA device.
"""

from __future__ import annotations

import torch

from kandinsky5_tpu_torch.ops.gemm import launch_gemm

# (M, K, N): the JAX tool's shape, then the 5 s DiT's projections (47,616
# tokens): attention 1792 -> 1792, FF in 1792 -> 7168, FF out 7168 -> 1792
SHAPES = ((8192, 8192, 8192), (47616, 1792, 1792), (47616, 1792, 7168),
          (47616, 7168, 1792))


def gemm_plain(a, b):
    """Plain PyTorch T1: a (M, K) . b (N, K)^T. int8 -> the exact int32
    product (through fp64, exact since |sum| <= K * 127^2 < 2^53); bf16 ->
    the fp32 product of the bf16 values."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double().T).to(torch.int32)
    return a.float() @ b.float().T


def gemm(a, b):
    """T1 wrapper: a (M, K), b (N, K), both int8 or both bf16; any M, N a
    multiple of 8, K a multiple of 16 (int8) or 8 (bf16). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    i8 = a.dtype == torch.int8
    return launch_gemm("T1_gemm_i8" if i8 else "T1_gemm_bf16", a, b,
                       torch.int8 if i8 else torch.bfloat16)


def operands(m, k, n, dtype, generator, device):
    """Seeded operands: int8 uniform in [-127, 127], or bf16 with A ~ N(0, 1)
    and B ~ N(0, 1/K) so the product is of order one."""
    if dtype == torch.int8:
        return (torch.randint(-127, 128, (m, k), generator=generator,
                              device=device, dtype=torch.int8),
                torch.randint(-127, 128, (n, k), generator=generator,
                              device=device, dtype=torch.int8))
    a = torch.randn((m, k), generator=generator, device=device)
    b = torch.randn((n, k), generator=generator, device=device) * k ** -0.5
    return a.bfloat16(), b.bfloat16()


def library_call(a, b):
    """The one PyTorch call that computes the same product: torch._int_mm
    for int8, bf16 torch.matmul (its output is bf16) for bf16."""
    bt = b.t()
    if a.dtype == torch.int8:
        return lambda: torch._int_mm(a, bt)
    return lambda: torch.matmul(a, bt)


def time_ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    from kandinsky5_tpu_torch.tools import gpu_line

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in SHAPES:
        ops = 2.0 * m * n * k
        for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
            a, b = operands(m, k, n, dtype, g, dev)
            t = time_ms(lambda: gemm(a, b))
            t_lib = time_ms(library_call(a, b))
            print(f"  ({m},{k},{n}) {name}: T1 {t:8.3f} ms {ops / t / 1e9:7.1f} "
                  f"T/s | library {t_lib:8.3f} ms {ops / t_lib / 1e9:7.1f} T/s",
                  flush=True)
            del a, b
    print(gpu_line())


if __name__ == "__main__":
    main()
