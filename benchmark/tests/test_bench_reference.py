"""The reference against the port's plain path on the CPU at a tiny size: the
forward in eval and train mode, the frame step's boxes, the loss terms and
one Adam update; MulTransformerBlock alone and in whole ``ptt_large`` and
``ptt_waymo`` forwards at published widths on narrowed clouds, with its FLOPs
by hand; the host subsample of frames above the padding; and the weight draw
of the benchmark's configurations, held to what it was."""

import hashlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

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
    inputs = ref_frame.FrameInputs(ref_frame.pack(tracklets, 1280, 9), data, cfg["TEST"], "cpu")
    u_s, u_t = ref_frame.uniforms(9, ref_frame.padded_frames(4), 2, 1024, 512, "cpu")
    np.testing.assert_array_equal(boxes[:, 0], ref_frame.pack(tracklets, 1280, 9)["init"])
    for t in range(1, 4):
        prev = torch.from_numpy(boxes[:, t - 1])
        s, tm = inputs.inputs(t, prev, u_s[t - 1], u_t[t - 1])
        with torch.no_grad():
            pred = ref_model.forward(P, cfg["MODEL"], s, tm)
        ref = ref_frame.best_box(pred["pred_box_data"], prev, bool(data.get("USE_Z_AXIS", False))).numpy()
        np.testing.assert_allclose(boxes[:, t], ref, rtol=0, atol=1e-5)


# ------------------------------------------------------- MulTransformerBlock

MUL_CONFIGS = ("kitti_models/ptt_large.yaml", "kitti_models/ptt_waymo.yaml")
BLOCK = "centroid_voting_head.transformer_block"
# the repo's module band (docs/PARITY.md section 2.1) is 2e-4; the eval paths
# run the same float32 operations but for LayerNorm's and the products' inner
# order, and agree to ~1e-6 on outputs of ~7, so they are held at 1e-5
EVAL_ATOL = 1e-5
# train mode: BatchNorm's batch statistics, which the port sums as E[x^2] -
# E[x]^2 in float64 and the reference as the biased variance in float32; the
# difference grows through the 20-odd BatchNorm layers to ~1e-4: the band
TRAIN_TOL = 2e-4


def _mul_setup(path, seed=5):
    from ptt_tpu_torch.config import config_by_path
    from ptt_tpu_torch.nn import build_network

    model_cfg = config_by_path(path)["MODEL"]
    P = ref_model.make_weights(ref_model.param_specs(model_cfg), seed, "cpu")
    model = build_network(model_cfg, device="cpu")
    model.load_state_dict(P, strict=True)
    return model_cfg, P, model


def _narrowed(model_cfg, B, seed):
    """Clouds a little above stage 0's centers: 256 search and 128 template
    points more."""
    sa = model_cfg["BACKBONE_3D"]["SA_CONFIG"]
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([2.0, 1.0, 0.8])
    return (torch.randn(B, int(sa["NPOINTS_SEARCH"][0]) + 256, 3, generator=g) * scale,
            torch.randn(B, int(sa["NPOINTS_TEMPLATE"][0]) + 128, 3, generator=g) * scale)


@pytest.mark.parametrize("n_points", [64, 128])
def test_mul_block(n_points):
    """The block alone at ptt_large's published widths (256 in, 512 wide, 4
    heads, 2 layers, 16 neighbours); the port's train mode too (dropout 0)."""
    from ptt_tpu_torch.nn.transformer import MulTransformerBlock

    model_cfg, P, _ = _mul_setup(MUL_CONFIGS[0])
    tb = model_cfg["CENTROID_HEAD"]["TRANSFORMER_BLOCK"]
    assert (tb["NAME"], tb["DIM_INPUT"], tb["DIM_MODEL"], tb["N_HEADS"], tb["N_LAYERS"], tb["KNN"]) == (
        "MulTransformerBlock", 256, 512, 4, 2, 16)
    block = MulTransformerBlock(256, 512, 16, 4, 2)
    block.load_state_dict({k[len(BLOCK) + 1:]: v for k, v in P.items() if k.startswith(BLOCK + ".")}, strict=True)
    g = torch.Generator().manual_seed(n_points)
    xyz, feats = torch.randn(2, n_points, 3, generator=g), torch.randn(2, n_points, 256, generator=g)
    with torch.no_grad():
        ref = ref_model.transformer_block(P, BLOCK, xyz, feats, tb)
        for mode in (block.eval, block.train):
            torch.testing.assert_close(mode()(xyz, feats)[0], ref, rtol=0, atol=EVAL_ATOL)


def test_mul_block_flops():
    """FlopCounterMode over the reference's block: 2 M N K of each product,
    by hand (fc1, q, k, v, proj and fc2 a point; fc_delta and the shared
    fc_gamma a neighbour, fc_gamma once a head)."""
    B, N, k, d_p, d_m, H = 2, 64, 16, 256, 512, 4
    h = d_m // H
    tb = {"ENABLE": True, "NAME": "MulTransformerBlock", "DIM_INPUT": d_p, "DIM_MODEL": d_m, "KNN": k,
          "N_HEADS": H, "N_LAYERS": 2}
    specs = []
    ref_model._block_specs(specs, "b", tb)
    P = ref_model.make_weights(specs, 1, "cpu")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref_model.transformer_block(P, "b", torch.randn(B, N, 3), torch.randn(B, N, d_p), tb)
    per_point = d_p * d_m + 3 * d_m * d_m + d_m * d_m + d_m * d_p
    per_neighbour = 3 * d_m + d_m * d_m + 2 * H * h * h
    assert counter.get_total_flops() == 2 * 2 * (B * N * per_point + B * N * k * per_neighbour)


@pytest.mark.parametrize("path", MUL_CONFIGS)
def test_mul_forward_eval(path):
    model_cfg, P, model = _mul_setup(path)
    s, t = _narrowed(model_cfg, 2, seed=3)
    with torch.no_grad():
        got = model.eval()({"search_points": s, "template_points": t})
        ref = ref_model.forward(P, model_cfg, s, t)
    assert torch.equal(got["search_inds"].long(), ref["search_inds"])
    for key in ("pred_centroids_votes", "pred_box_center", "pred_box_data"):
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=EVAL_ATOL)


def test_mul_forward_train():
    model_cfg, P, model = _mul_setup(MUL_CONFIGS[0])
    s, t = _narrowed(model_cfg, 2, seed=4)
    with torch.no_grad():
        got = model.train()({"search_points": s, "template_points": t})
        ref = ref_model.forward(P, model_cfg, s, t, train=True)
    assert torch.equal(got["search_inds"].long(), ref["search_inds"])
    for key in ("pred_centroids_votes", "pred_box_center", "pred_box_data"):
        torch.testing.assert_close(got[key], ref[key], rtol=TRAIN_TOL, atol=TRAIN_TOL)


def test_other_blocks_refused():
    model_cfg = load_cell("ptt.track").config["MODEL"]
    for name, heads in (("TransformerBlockCosine", 1), ("MulTransformerBlock", 3)):
        model_cfg["BOX_HEAD"]["TRANSFORMER_BLOCK"].update(NAME=name, N_HEADS=heads)
        with pytest.raises(NotImplementedError):
            ref_model.param_specs(model_cfg)


# ---------------------------------------------------------- the host subsample


def test_pack_subsample_equals_the_program():
    """Frames above the padding keep the points the tracker's draws keep, bit
    for bit against the program's ``_pack``; frames at or under it are
    copied whole."""
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator

    from benchmark.gen.tracklets import make_tracklets

    cfg, _, model = _setup("ptt.track")
    tracklets = make_tracklets(3, 5, 600, 400, 21)  # 1120 points a frame
    for clouds, _, _ in tracklets[:2]:
        clouds[1], clouds[3] = clouds[1][:700], clouds[3][:1024]
    seed = 2**31 + 4321
    ev = DeviceTrackingEvaluator(cfg, model.eval(), max_points=1024, batch_size=3, seed=seed, device="cpu")
    got = ev._pack(tracklets)
    ref = ref_frame.pack(tracklets, 1024, seed)
    assert got["pcs"].shape[2] == 1024
    np.testing.assert_array_equal(got["pcs"][:, :5].numpy(), ref["pcs"])
    np.testing.assert_array_equal(got["counts"][:, :5].numpy(), ref["counts"])
    assert ref["counts"][0].tolist() == [1024, 700, 1024, 1024, 1024]
    np.testing.assert_array_equal(ref["pcs"][0, 1, :700], np.round(tracklets[0][0][1] * 256).astype(np.int16))


# ------------------------------------------------------ the weights, held fixed

# sha256 of repr(param_specs) and of every tensor of make_weights(specs,
# 20261018, "cpu") in order (name, then bytes), as the parent tree of the
# MulTransformerBlock reference drew them
DRAWS = {
    "ptt": (172, "372e5d48dbd2df7195815e25c396407061a4763aa5253fdef2220da4f0ce8e5a",
            "5af44955bd1e47c77d8f0ec39050a4f0aab67eb13327528af2444d6fdfe963b7"),
    "p2b": (142, "c01ecf6033eb0ed3aa0661590f304bb1d50e414c82fad6a35ca6066ec1c2f917",
            "db4ad41d75df7144b68d76712f8c2c2b23c8313b01df3d4982cd1b9b788238c9"),
}


@pytest.mark.parametrize("config", sorted(DRAWS))
def test_weight_draw_unchanged(config):
    cell = {"ptt": "ptt.track", "p2b": "p2b.train"}[config]
    specs = ref_model.param_specs(load_cell(cell).config["MODEL"])
    weights = ref_model.make_weights(specs, 20261018, "cpu")
    draw = hashlib.sha256()
    for name, _, _, _ in specs:
        draw.update(name.encode())
        draw.update(weights[name].numpy().tobytes())
    assert (len(specs), hashlib.sha256(repr(specs).encode()).hexdigest(), draw.hexdigest()) == DRAWS[config]
