"""The command-line entry points of the port, run as modules:

    python3 -m ptt_tpu_torch.tools.train_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml ...
    python3 -m ptt_tpu_torch.tools.test_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml --ckpt ...

Configurations are chosen by their ``tools/cfgs/`` path (``config.config_by_path``)
and run on the GPU unless ``--device cpu`` is given. Each CLI logs, as its last
line, ``summary`` and a JSON object of its results and the kernel launches it
made.
"""

from __future__ import annotations

import json


def kernel_launches() -> dict:
    """The launch counts of the port's CUDA kernels in this process so far."""
    from ..ops import fps, group, sa

    return {"fps": fps.launches, "sa": sa.launches, "group_fwd": group.fwd_launches,
            "group_bwd": group.bwd_launches}


def describe_device(device) -> str:
    """The device and, for a GPU, its name."""
    import torch

    return f"{device} ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else str(device)


def summary_line(record: dict) -> str:
    return "summary " + json.dumps(record)
