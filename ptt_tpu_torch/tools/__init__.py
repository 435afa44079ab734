"""The command-line entry points of the port, run as modules:

    python3 -m ptt_tpu_torch.tools.train_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml ...
    python3 -m ptt_tpu_torch.tools.test_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml --ckpt ...

Configurations are chosen by their ``tools/cfgs/`` path (``config.config_by_path``)
and run on the GPU unless ``--device cpu`` is given. Each CLI logs, as its last
line, ``summary`` and a JSON object of its results, the kernel launches it
made, the graphs it captured and the kernel libraries it built. With
``--launcher pytorch`` each is one rank of the processes ``torchrun`` started
(``launch``).

The JAX package's other tools are modules here too, each with ``main(argv)``
and ``--device`` (default cuda): ``train_bench``, ``demo_tracking``,
``convert_checkpoint``, ``fused_ab``, ``parity_decomposition``,
``compile_diag``, ``warmup`` and ``train_ablate``; ``bench_setup`` holds the
workloads they share.
"""

from __future__ import annotations

import json


def kernel_launches() -> dict:
    """The launch counts of the port's CUDA kernels in this process so far."""
    from ..utils import timer
    from ..utils.cuda_graph import LAUNCHES

    return {name.split(".", 1)[1]: timer.counter(name) for name in LAUNCHES}


def build_counts() -> dict:
    """The CUDA graphs captured and the kernel libraries built (``nvcc`` or
    ``g++``) in this process so far."""
    from ..utils import timer

    return {"graph_captures": timer.counter("graph.captures"), "kernel_builds": timer.counter("kernels.builds")}


def describe_device(device) -> str:
    """The device and, for a GPU, its name."""
    import torch

    return f"{device} ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else str(device)


def summary_line(record: dict) -> str:
    return "summary " + json.dumps(record)


def add_launcher_args(parser) -> None:
    """The flags of a data-parallel run: ``--launcher``, ``--dist_backend``,
    ``--init_method``."""
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="'pytorch': one of the processes torchrun started, one a GPU")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default="nccl",
                        help="torch.distributed backend of --launcher pytorch")
    parser.add_argument("--init_method", type=str, default="env://",
                        help="torch.distributed init method (torchrun's environment, or file://PATH)")


def launch(args, run) -> int:
    """``run(rank, world)`` in this process alone, or with ``--launcher
    pytorch`` as one rank of the process group torchrun's environment (or
    ``--init_method``) describes, which is left when ``run`` ends."""
    if args.launcher == "none":
        return run(0, 1)
    import torch.distributed as dist

    from ..utils.dist import init_distributed

    rank, world, _ = init_distributed(args.dist_backend, args.init_method, args.device)
    try:
        return run(rank, world)
    finally:
        dist.destroy_process_group()


def describe_process(device, args, rank: int, world: int) -> str:
    """The device, and this process's place in its group."""
    return (f"device {describe_device(device)}; process {rank}/{world}"
            + (f", backend {args.dist_backend}" if args.launcher == "pytorch" else ""))
