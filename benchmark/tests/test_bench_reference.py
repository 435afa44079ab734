"""The reference against the port's plain path on the CPU at a tiny size: the
forward in eval and train mode, the frame step's boxes, the loss terms and
one Adam update."""

import numpy as np
import pytest
import torch

from benchmark.reference import frame as ref_frame
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.run import load_cell

CELLS = ("ptt.track", "p2b.train")  # one cell of each configuration


def _setup(cell, seed=5):
    from ptt_tpu_torch.nn import build_network

    cfg = load_cell(cell).config
    P = ref_model.make_weights(ref_model.param_specs(cfg["MODEL"]), seed, "cpu")
    model = build_network(cfg["MODEL"], device="cpu")
    model.load_state_dict(P, strict=True)
    return cfg, P, model


def _clouds(B, seed=0):
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([2.0, 1.0, 0.8])
    return torch.randn(B, 1024, 3, generator=g) * scale, torch.randn(B, 512, 3, generator=g) * scale


@pytest.mark.parametrize("cell", CELLS)
def test_forward_eval(cell):
    cfg, P, model = _setup(cell)
    s, t = _clouds(2)
    with torch.no_grad():
        got = model.eval()({"search_points": s, "template_points": t})
        ref = ref_model.forward(P, cfg["MODEL"], s, t)
    assert torch.equal(got["search_inds"].long(), ref["search_inds"])
    for key in ("pred_centroids_votes", "pred_box_center", "pred_box_data"):
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_losses_and_adam(cell):
    """Train mode: the loss terms on the same outputs, then one update of
    each side's optimizer from the same gradients."""
    from ptt_tpu_torch.nn.losses import compute_losses
    from ptt_tpu_torch.train.optim import Optimizer

    cfg, P, model = _setup(cell)
    s, t = _clouds(4, seed=1)
    batch = {"search_points": s, "template_points": t,
             "cls_label": (torch.rand(4, 1024, generator=torch.Generator().manual_seed(2)) < 0.3).float(),
             "reg_label": torch.tensor([[0.1, -0.2, 0.05, 10.0]] * 4)}
    out = model.train()(batch)
    _, terms = compute_losses(cfg["MODEL"], out, batch)
    ref_terms = ref_train.losses(cfg["MODEL"], {k: v.detach() for k, v in out.items()}, batch)
    for key, value in ref_terms.items():
        torch.testing.assert_close(terms[key].detach(), value, rtol=1e-6, atol=1e-7)
    terms["loss"].backward()
    names = [n for n, _ in model.named_parameters()]
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], 100)
    opt.step()
    ref_opt = ref_train.Adam(names, params, cfg["OPTIMIZATION"])
    ref_opt.update(params, ref_opt.clipped(grads))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cell", CELLS)
def test_frame_step_boxes(cell):
    """The port's eager tracker on two 4-frame tracklets, frame by frame
    against the reference's frame step from the port's previous boxes."""
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator

    from benchmark.gen.tracklets import make_tracklets

    cfg, P, model = _setup(cell)
    tracklets = make_tracklets(2, 4, 600, 400, 9)
    ev = DeviceTrackingEvaluator(cfg, model.eval(), max_points=2048, batch_size=2, seed=9, device="cpu")
    boxes = ev.boxes(ev.dispatch_batch(tracklets)).numpy()
    data = cfg["DATA_CONFIG"]
    inputs = ref_frame.FrameInputs(ref_frame.pack(tracklets, 1280), data, cfg["TEST"], "cpu")
    u_s, u_t = ref_frame.uniforms(9, ref_frame.padded_frames(4), 2, 1024, 512, "cpu")
    np.testing.assert_array_equal(boxes[:, 0], ref_frame.pack(tracklets, 1280)["init"])
    for t in range(1, 4):
        prev = torch.from_numpy(boxes[:, t - 1])
        s, tm = inputs.inputs(t, prev, u_s[t - 1], u_t[t - 1])
        with torch.no_grad():
            pred = ref_model.forward(P, cfg["MODEL"], s, tm)
        ref = ref_frame.best_box(pred["pred_box_data"], prev, bool(data.get("USE_Z_AXIS", False))).numpy()
        np.testing.assert_allclose(boxes[:, t], ref, rtol=0, atol=1e-5)
