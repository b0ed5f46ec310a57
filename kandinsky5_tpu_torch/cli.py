"""Generation CLI of the PyTorch port, flag-compatible with the reference
``test.py`` (and the JAX package's ``cli.py``).

    python -m kandinsky5_tpu_torch.cli \\
        --config kandinsky5_tpu_torch/configs/config_5s_distil.yaml \\
        --prompt "A dog in red hat" --output_filename out.mp4

It runs on the CUDA card unless ``--device cpu`` is given. ``--int8_linear``
(W8A8 visual projections), ``--int8_expand`` (int8 decode weights for
prompt expansion; under ``--tp`` each rank keeps the whole tower, as the
JAX pipeline does) and ``--attn`` (the DiT's attention: ``flash_int8`` is
the int8-QK K5, ``flash_int8_pipe`` K7) are flags here, where the JAX
package reads environment variables; every one of them runs under
``--tp``. ``--tp N`` runs N ranks over ``torch.distributed`` (NCCL with a
card per rank, else gloo), each building the pipeline from the same
checkpoints on the mesh the JAX factory plans for N devices
(``plan_dit_mesh(N, heads)``: 8 devices and 28 heads run (1, 2, 4), tp 4
over the heads and sp 2 over the sequence); every rank decodes its share
of the tiles, rank 0 blends them and writes. Over several hosts each host
runs the command with ``--nnodes H --node-rank h --master-addr A
--master-port P`` (arguments: nothing is read from the environment); ``--tp
N`` is then the width of each tp row, which must divide a host's ranks
(one a card; with ``--device cpu`` ``--nproc-per-node``, by default N),
and the mesh is JAX's hybrid one: dp over the hosts, the host's other ranks
in-host dp (``plan_hybrid_mesh``).
``--trace_dir DIR`` traces the request with ``torch.profiler`` into
``DIR/trace.json`` (rank 0's), where the JAX package reads
``KANDINSKY5_TPU_TRACE_DIR``.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser("kandinsky5_tpu_torch text-to-video generation")
    p.add_argument("--config", type=str, default=None,
                   help="path to a configs/*.yaml file")
    p.add_argument("--prompt", type=str, default="A dog in red hat")
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--width", type=int, default=768, choices=[512, 768])
    p.add_argument("--height", type=int, default=512, choices=[512, 768])
    p.add_argument("--video_duration", type=int, default=5,
                   help="seconds; 0 generates a single image")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--expand_prompt", type=int, default=1, choices=[0, 1])
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--guidance_weight", type=float, default=None)
    p.add_argument("--scheduler_scale", type=float, default=5.0)
    p.add_argument("--output_filename", type=str, default="output.mp4")
    p.add_argument("--cache_dir", type=str, default="./weights/")
    p.add_argument("--offload", action="store_true")
    p.add_argument("--magcache", action="store_true")
    p.add_argument("--tp", type=int, default=None,
                   help="device count: that many rank processes on the "
                   "(dp, sp, tp) mesh plan_dit_mesh plans for them")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--int8_linear", action="store_true",
                   help="W8A8 projections in the DiT's visual blocks")
    p.add_argument("--int8_expand", action="store_true",
                   help="int8 decode weights for prompt expansion")
    p.add_argument("--attn", type=str, default="auto",
                   choices=["auto", "flash", "dense", "flash_int8",
                            "flash_int8_pipe"],
                   help="the DiT's attention (flash_int8: the int8-QK "
                   "kernel)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the request "
                   "here")
    add_node_args(p)
    return p.parse_args(argv)


def add_node_args(p) -> None:
    """The arguments of a launch over several hosts (the CLI's and the
    server's)."""
    p.add_argument("--nnodes", type=int, default=1,
                   help="hosts of the launch (each runs this command)")
    p.add_argument("--node-rank", type=int, default=0,
                   help="this host's index, 0 to nnodes - 1")
    p.add_argument("--master-addr", type=str, default=None,
                   help="address of host 0, where global rank 0 serves the "
                   "ranks' TCPStore")
    p.add_argument("--master-port", type=int, default=None,
                   help="a free port on host 0 for the TCPStore")
    p.add_argument("--nproc-per-node", type=int, default=None,
                   help="with --device cpu, ranks on each host (default "
                   "--tp); on the card a host runs one rank a card")


def validate_args(args):
    if args.width == args.height == 768:
        raise ValueError(
            "(768, 768) resolution is not supported; use (512, 512), "
            "(512, 768) or (768, 512)")


def generate(mesh, args):
    """Build the pipeline from ``args`` (as the rank at ``mesh``, a
    ``RankMesh``, or alone when None) and answer the one request; returns
    the path written (None off rank 0). Module-level, so that
    ``parallel.launch``'s ranks can import it."""
    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE, get_T2V_pipeline
    from kandinsky5_tpu_torch.utils.trace import profiled

    pipe = get_T2V_pipeline(
        conf_path=args.config, cache_dir=args.cache_dir,
        offload=args.offload, magcache=args.magcache, tp=mesh,
        int8_linear=args.int8_linear, int8_expand=args.int8_expand,
        attn_impl=args.attn, device=args.device)
    trace_dir = args.trace_dir if mesh is None or mesh.rank == 0 else None
    with profiled(trace_dir):
        frames = pipe(
            args.prompt,
            time_length=args.video_duration,
            width=args.width,
            height=args.height,
            seed=args.seed,
            num_steps=args.sample_steps,
            guidance_weight=args.guidance_weight,
            scheduler_scale=args.scheduler_scale,
            negative_caption=(DEFAULT_NEGATIVE if args.negative_prompt is None
                              else args.negative_prompt),
            expand_prompts=bool(args.expand_prompt),
            save_path=args.output_filename,
        )
    return None if frames is None else pipe.timings["saved"][0]


def mesh_plan(args):
    """(dp, sp, tp) of ``--tp N``: ``plan_dit_mesh(N, heads)`` for the
    configuration's DiT, as the JAX package's ``get_T2V_pipeline(tp=N)``
    plans it."""
    from kandinsky5_tpu_torch.config import DiTParams, load_config
    from kandinsky5_tpu_torch.parallel.sharding import plan_dit_mesh

    cfg = (load_config(args.config).model.dit_params if args.config
           else DiTParams())
    return plan_dit_mesh(args.tp, cfg.num_heads)


def launch_plan(args):
    """The ``parallel.launch`` arguments of ``--tp`` and the node arguments
    (``world``, ``backend``, ``device``, ``dp``, ``sp``, ``nodes``,
    ``node_rank``, ``master``), or None for one process. One host: ``--tp
    N`` ranks on ``plan_dit_mesh(N, heads)``. Several: the hybrid mesh of
    ``plan_hybrid_mesh(N, ranks per host, hosts)``. The backend is NCCL
    with a card per rank of the host, else gloo."""
    import torch

    from kandinsky5_tpu_torch.parallel.sharding import plan_hybrid_mesh

    device = "cpu" if args.device == "cpu" else "cuda"
    nodes = args.nnodes
    if nodes > 1:
        if args.master_addr is None or args.master_port is None:
            raise ValueError("a launch over several hosts needs "
                             "--master-addr and --master-port")
        tp = args.tp or 1
        if device == "cuda":
            if args.nproc_per_node is not None:
                raise ValueError("--nproc-per-node is for --device cpu: on "
                                 "the card a host runs one rank a card")
            per = torch.cuda.device_count()
        else:
            per = args.nproc_per_node or tp
        dp, sp, _ = plan_hybrid_mesh(tp, per, nodes)
        master = (args.master_addr, args.master_port)
    elif args.tp is not None and args.tp > 1:
        per = args.tp
        dp, sp, _ = mesh_plan(args)
        master = None
    else:
        return None
    backend = ("nccl" if device == "cuda"
               and torch.cuda.device_count() >= per else "gloo")
    return dict(world=per * nodes, backend=backend, device=device, dp=dp,
                sp=sp, nodes=nodes, node_rank=args.node_rank, master=master)


def main(argv=None):
    args = parse_args(argv)
    validate_args(args)
    start = time.time()
    plan = launch_plan(args)
    if plan is not None:
        from kandinsky5_tpu_torch.parallel import launch

        written = launch(generate, plan.pop("world"), plan.pop("backend"),
                         plan.pop("device"), args=(args,), **plan)[0]
    else:
        written = generate(None, args)
    print(f"generated in {time.time() - start:.1f}s -> {written}")
    return written


if __name__ == "__main__":
    main()
