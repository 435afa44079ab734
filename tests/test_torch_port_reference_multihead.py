"""The port's MulTransformerBlock and ``ptt_waymo``'s eval forward against the
benchmark's plain reference (``benchmark/reference/model.py``: plain PyTorch
float32, nothing of the port or of JAX) on its seeded weights
(``make_weights``), on the CPU; the benchmark's ``ptt_waymo`` configuration
against the port's ``kitti_models/ptt_waymo.yaml``; and the reference's
imports."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.reference import model as ref_model
from ptt_tpu_torch.config import config_by_path
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.nn.transformer import MulTransformerBlock

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PATH = "kitti_models/ptt_waymo.yaml"
BLOCK = "centroid_voting_head.transformer_block"
# The module band of docs/PARITY.md section 2.1 is 2e-4. Both sides run the
# same float32 operations but for the order of LayerNorm's and the products'
# inner sums, and agree to ~2.6e-6 on the block's outputs and ~1e-6 on the
# forward's (outputs of order 1 to 10), so they are held at 1e-5, inside it.
EVAL_ATOL = 1e-5


@pytest.fixture(scope="module")
def waymo():
    model_cfg = config_by_path(PATH)["MODEL"]
    P = ref_model.make_weights(ref_model.param_specs(model_cfg), 2**31 + 22, "cpu")
    return model_cfg, P


@pytest.mark.parametrize("n_points", [64, 128])
def test_mul_block_at_published_widths(waymo, n_points):
    """The block alone at ``ptt_waymo``'s widths (256 in, 512 wide, 4 heads of
    128, 2 layers, 16 neighbours), in eval and in train mode (its dropout is
    0, so the two agree)."""
    model_cfg, P = waymo
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
            got, attn = mode()(xyz, feats)
            torch.testing.assert_close(got, ref, rtol=0, atol=EVAL_ATOL)
    assert attn.shape == (2, 4, n_points, 16, 128)


def test_ptt_waymo_eval_forward(waymo):
    """The whole eval forward at published widths on narrowed clouds (256
    search and 128 template points above stage 0's 2048 and 1024 centers):
    the same search seeds (``search_inds`` equal: FPS and the sequence
    sampling pick the same points), the votes, centres and proposals within
    EVAL_ATOL."""
    model_cfg, P = waymo
    model = build_network(model_cfg, device="cpu")
    model.load_state_dict(P, strict=True)
    g = torch.Generator().manual_seed(3)
    scale = torch.tensor([2.0, 1.0, 0.8])
    search = torch.randn(1, 2048 + 256, 3, generator=g) * scale
    template = torch.randn(1, 1024 + 128, 3, generator=g) * scale
    with torch.no_grad():
        got = model.eval()({"search_points": search, "template_points": template})
        ref = ref_model.forward(P, model_cfg, search, template)
    assert torch.equal(got["search_inds"].long(), ref["search_inds"])
    for key in ("pred_centroids_votes", "pred_box_center", "pred_box_data"):
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=EVAL_ATOL)


def test_benchmark_config_is_the_ports():
    """``benchmark/configs/ptt_waymo.json`` runs the port's ptt_waymo.yaml:
    MODEL, OPTIMIZATION and TEST equal; DATA_CONFIG the benchmark's synthetic
    one at the yaml's input sizes, the one key it lists as reduced."""
    bench = json.loads((ROOT / "benchmark" / "configs" / "ptt_waymo.json").read_text())
    port = config_by_path(PATH)
    for key in ("MODEL", "OPTIMIZATION", "TEST"):
        assert bench[key] == port[key], key
    assert bench["reduced"] == ["DATA_CONFIG"]
    for key in ("SEARCH_INPUT_SIZE", "TEMPLATE_INPUT_SIZE"):
        assert bench["DATA_CONFIG"][key] == port["DATA_CONFIG"][key]


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; import benchmark.reference.model, benchmark.reference.frame; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'ptt_tpu', "
            "'ptt_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
