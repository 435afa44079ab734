"""Convert checkpoints between the reference PyTorch layout and this package
(the JAX package's ``tools/convert_checkpoint.py``).

Forward (the default): a reference ``.pth`` becomes a checkpoint of this
package, which ``train/checkpoint.py`` ``load_params_from_file`` and the test
CLI's ``--ckpt`` read::

    python3 -m ptt_tpu_torch.tools.convert_checkpoint --cfg_file tools/cfgs/kitti_models/ptt.yaml \\
        --torch_ckpt ptt_kitti_car.pth --out converted.pth

Reverse: a checkpoint of this package, a JAX-package ``.npz`` or a ``.pth``
becomes a reference-layout ``.pth``::

    python3 -m ptt_tpu_torch.tools.convert_checkpoint --reverse --cfg_file ... \\
        --ckpt tests/assets/ptt_synth_trained.npz --out exported.pth [--template reference.pth]

The forward conversion is strict by default: every weight of the
configuration's tracker must come from the file, of its shape, and every
tensor of the file (the reference's buffers that are not weights aside) must
be used; ``--no-strict`` converts what matches, keeps the model's init for the
rest and reports both. ``--template`` makes the reverse export take the
template's shapes and carry its buffers this package has no counterpart for
(``num_batches_tracked``, the loss's ``pos_weight``, ``global_step``), so
that the reference's ``load_state_dict(strict=True)`` takes the file.

The forward output is a ``.pth`` ({"model_state": state_dict, "epoch": 0,
"source", "cfg"}). The tool reads and writes the named local files only. The
model is built on ``--device`` (CUDA unless asked for the CPU) to take its
shapes; nothing else runs there.
"""

from __future__ import annotations

import argparse

import torch


def _reference_payload(path) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("model_state", payload) if isinstance(payload, dict) else payload


def forward_convert(model, torch_ckpt, strict: bool = True):
    """The reference file's weights in this package's keys -> (state, report):
    report's "missing" lists the model's tensors not found (or of another
    shape), "unused" the file's tensors left over; strict raises ValueError
    if either is not empty. Missing tensors keep the model's values."""
    from ..convert import state_dict_from_reference

    template = model.state_dict()
    state, problems = state_dict_from_reference(_reference_payload(torch_ckpt), template)
    report = {"missing": [p for p in problems if not p.startswith("unused: ")],
              "unused": [p for p in problems if p.startswith("unused: ")]}
    if strict and (report["missing"] or report["unused"]):
        raise ValueError(f"conversion incomplete: {report}")
    return {key: state.get(key, value) for key, value in template.items()}, report


def reverse_export(model, ckpt, template=None, strict: bool = True) -> dict:
    """The weights of ``ckpt`` (see ``load_params_from_file``) in the reference
    layout; with ``template`` (a reference state_dict) in its shapes and with
    its buffers that are not weights. Raises ValueError if the template names
    a tensor the export lacks."""
    from ..convert import IGNORED_REFERENCE_SUFFIXES, reference_state_dict
    from ..train.checkpoint import load_params_from_file, resolve_checkpoint_path

    load_params_from_file(resolve_checkpoint_path(ckpt), model, strict=strict)
    out = reference_state_dict(model.state_dict())
    if template is None:
        return out
    missing = sorted(key for key in template if key not in out and not key.endswith(IGNORED_REFERENCE_SUFFIXES))
    if missing:
        raise ValueError(f"export incomplete vs template: missing {missing}")
    for key, value in template.items():
        if key.endswith(IGNORED_REFERENCE_SUFFIXES):
            out[key] = torch.as_tensor(value).clone()
        else:
            out[key] = out[key].reshape(tuple(value.shape))
    return out


def _n_parameters(state: dict) -> int:
    """Tensors that are flax parameters (not BatchNorm statistics)."""
    return sum(not key.endswith(("running_mean", "running_var", "num_batches_tracked")) for key in state)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="convert checkpoints between the reference layout and this package")
    parser.add_argument("--cfg_file", type=str, required=True,
                        help="model config matching the checkpoint's architecture")
    parser.add_argument("--torch_ckpt", type=str, default=None, help="(forward) reference .pth to convert")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="(reverse) checkpoint of this package, a JAX-package .npz or a .pth to export")
    parser.add_argument("--out", type=str, required=True,
                        help="output: a checkpoint of this package (forward) or a reference .pth (reverse)")
    parser.add_argument("--reverse", action="store_true", default=False,
                        help="export to the reference layout instead")
    parser.add_argument("--template", type=str, default=None,
                        help="(reverse) reference .pth whose shapes and buffers to match")
    parser.add_argument("--no-strict", dest="strict", action="store_false", default=True)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..config import cli_config
    from ..nn import build_network

    cfg = cli_config(args.cfg_file, args.set_cfgs)
    model = build_network(cfg["MODEL"], device=resolve_device(args.device))

    if args.reverse:
        if args.ckpt is None:
            parser.error("--reverse needs --ckpt")
        template = _reference_payload(args.template) if args.template else None
        state = reverse_export(model, args.ckpt, template, strict=args.strict)
        torch.save({"model_state": state, "epoch": 0}, args.out)
        print(f"exported {_n_parameters(model.state_dict())} parameter tensors to torch checkpoint {args.out}")
        return 0

    if args.torch_ckpt is None:
        parser.error("forward conversion needs --torch_ckpt")
    state, report = forward_convert(model, args.torch_ckpt, strict=args.strict)
    if report["missing"] or report["unused"]:
        print(f"partial conversion: {len(report['missing'])} missing, {len(report['unused'])} unused torch tensors")
        for line in report["missing"][:10] + report["unused"][:10]:
            print("  ", line)
    torch.save({"model_state": {key: value.cpu() for key, value in state.items()}, "epoch": 0,
                "source": str(args.torch_ckpt), "cfg": str(args.cfg_file)}, args.out)
    print(f"wrote {_n_parameters(state)} parameter tensors to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
