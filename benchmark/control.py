"""Readings of the control and of planted faults, for setting the limits of
the check that decides ``correct`` (never run by ``run.py``).

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

Track cells: a short window of the program at the cell's own load, then, on
the check's own sample, the sound numbers (the program against the float32
reference) and the control's: the reference's frame step in the program's
place with every product in TF32, from the same previous boxes; and for the
scores, the reference scorer on boxes rounded to bfloat16 against float32.
Also a fault: the program's answers for the batch's last tracklet moved 0.5 m
from the middle frame on. Train cells: the program's set-up (step 0 and its
checked steps, no window) against the reference; then the reference in TF32,
and with each step's loss over the first half of the batch only, against the
float32 reference; and the worst parameter of the change with its sizes. One
JSON line a seed; all seeds in one process, on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402


def track_readings(spec, seed: int, seconds: float) -> dict:
    import torch

    from benchmark.mixes import track

    state = track.Track(SimpleNamespace(config=spec.config, traffic=spec.traffic, seed=seed, device="cuda",
                                        mark=lambda phase: None))
    state.window(seconds, False)
    state.release()
    sample = state.sample()
    ref = state.follow(sample)
    got = {(d, t): state.done[d][1][:, t] for d, t in ref}
    sound = dict(track.compare_boxes(got, ref),
                 **state.compare_scores((state.summary["success"], state.summary["precision"])))
    tf32 = state.follow(sample, tf32=True)
    control = dict(track.compare_boxes(tf32, ref), **state.compare_scores(state.score_reference(torch.bfloat16)))
    return {"sound": sound, "control": control, "slot_fault": track.compare_boxes(slot_fault(got, state.T), ref),
            "pairs": len(sample)}


def slot_fault(got: dict, frames: int) -> dict:
    """``got`` with the last tracklet's boxes moved 0.5 m along x from the
    middle frame on: what a program whose loop moved those answers where it
    produced them reads, since the reference crops each frame around the
    program's previous box and so stays 0.5 m from the moved answer."""
    out = {}
    for (d, t), boxes in got.items():
        boxes = boxes.copy()
        if t >= frames // 2:
            boxes[-1, 0] += 0.5
        out[(d, t)] = boxes
    return out


def _step_gaps(got, ref):
    """Each checked step's relative loss gap, and the first one's of every
    loss term."""
    got, ref = got["steps"], ref["steps"]
    return {"steps": [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got["losses"], ref["losses"])],
            "terms1": {k: abs(got["losses"][0][k] - v) / abs(v) for k, v in ref["losses"][0].items() if v}}


def _worst_leaf(state, got, ref) -> dict:
    """The parameter of the change's worst gap, with its size, its share of
    entries that moved by under half a learning rate on either side, and its
    reference gradient over the median parameter's."""
    import numpy as np

    from benchmark.mixes import train

    leaves = state.leaves(got["steps"], ref["steps"])
    gaps = train.leaf_gaps(leaves["d_got"], leaves["d_ref"], leaves["moving"])
    name = max(gaps, key=gaps.get)
    p0 = state.state0["params"][name]
    lr = float(state.ctx.config["OPTIMIZATION"]["LR"])
    small = [float(((side["params"][name] - p0).abs() < 0.5 * lr).float().mean()) for side in (got["steps"], ref["steps"])]
    med = float(np.median(list(leaves["grad"].values())))
    return {"name": name, "gap": gaps[name], "numel": int(p0.numel()), "d_got": leaves["d_got"][name],
            "d_ref": leaves["d_ref"][name], "grad_over_median": leaves["grad"][name] / med,
            "still_share": small, "median_gap": float(np.median(list(gaps.values())))}


def train_readings(spec, seed: int) -> dict:
    """The program's checked steps (set-up only, no window), the TF32
    control and the half-batch fault against the reference, each with its
    loss gap step by step and its change's worst parameter."""
    from benchmark.mixes import train

    state = train.Train(SimpleNamespace(config=spec.config, traffic=spec.traffic, seed=seed, device="cuda",
                                        mark=lambda phase: None))
    state.release()
    ref = state.reference()
    out = {}
    for kind, got in (("sound", state.program_readings()), ("control", state.reference(tf32=True)),
                      ("half_batch", state.reference(half=True))):
        out[kind] = dict(state.compare(got, ref), **_step_gaps(got, ref), worst_leaf=_worst_leaf(state, got, ref))
    out["unchanged_state"] = {"change_gap": 1.0}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    args = parser.parse_args(argv)
    spec = run.load_cell(args.workload)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        if spec.traffic["kind"] == "track":
            out = track_readings(spec, seed, args.seconds)
        else:
            out = train_readings(spec, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
