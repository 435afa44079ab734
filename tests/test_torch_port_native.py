"""The port's native C++ host library (``ptt_tpu_torch/native``) against the
JAX package's (``ptt_tpu/native``), the same source built with the same
flags: every function bit for bit on the same numpy inputs. The port's
``fps`` and ``ball_query`` equal its plain point ops too, a third witness.
Four processes that build into one fresh directory at once all load the
library, and a failed build raises with g++'s output."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ptt_tpu.native as jnative
from ptt_tpu_torch import native
from ptt_tpu_torch.ops import point_ops

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _boxes7(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.uniform(-5, 5, (n, 3))
    b[:, 3:6] = rng.uniform(1, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("B", [None, 3])
def test_sampling_and_grouping_bit_equal_to_jax(rng, B):
    shape = (500, 3) if B is None else (B, 500, 3)
    xyz = rng.uniform(-2, 2, shape).astype(np.float32)
    centers = xyz[..., :40, :]
    np.testing.assert_array_equal(native.fps(xyz, 64), jnative.fps(xyz, 64))
    np.testing.assert_array_equal(native.ball_query(xyz, centers, 0.4, 16), jnative.ball_query(xyz, centers, 0.4, 16))
    d2 = ((xyz[..., :, None, :] - xyz[..., None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(native.fps_with_dist(d2, 64), jnative.fps_with_dist(d2, 64))


def test_fps_and_ball_query_equal_the_plain_point_ops(rng):
    """The third witness: the C++ oracle, the plain PyTorch ops and (held
    elsewhere) the JAX ops give the same indices."""
    xyz = rng.uniform(-2, 2, (3, 700, 3)).astype(np.float32)
    centers = xyz[:, 100:164]
    t = torch.from_numpy(xyz)
    np.testing.assert_array_equal(native.fps(xyz, 128), point_ops.furthest_point_sample(t, 128).numpy())
    np.testing.assert_array_equal(native.ball_query(xyz, centers, 0.3, 32),
                                  point_ops.ball_query(0.3, 32, t, torch.from_numpy(centers)).numpy())


@pytest.mark.parametrize("slack", [0.0, 1.4])
def test_crop_canonical_bit_equal_to_jax(rng, slack):
    pts = rng.uniform(-8, 8, (3000, 3)).astype(np.float32)
    box = np.array([0.5, -1.0, 0.2, 0.7], np.float32)
    wlh = np.array([1.8, 4.2, 1.6], np.float32)
    ours, mask = native.crop_canonical(pts, box, wlh, slack, 1.25)
    ref, ref_mask = jnative.crop_canonical(pts, box, wlh, slack, 1.25)
    assert mask.any() and ours.shape[0] == int(mask.sum())
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(mask, ref_mask)


@pytest.mark.parametrize("use_z", [False, True])
def test_decode_box_offset_bit_equal_to_jax(rng, use_z):
    for _ in range(10):
        box = rng.uniform(-3, 3, 4).astype(np.float32)
        off = rng.uniform(-1, 1, 4).astype(np.float32) * np.array([1, 1, 1, 30], np.float32)
        np.testing.assert_array_equal(native.decode_box_offset(box, off, use_z),
                                      jnative.decode_box_offset(box, off, use_z))


@pytest.mark.parametrize("z_axis", [False, True])
def test_box_iou3d_batch_bit_equal_to_jax(rng, z_axis):
    a = _boxes7(rng, 64)
    b = a + rng.normal(0, 0.3, a.shape).astype(np.float32)
    b[:4] = a[:4]  # the identical-box shortcut
    b[4:8, :2] += 20.0  # no overlap
    iou, dist = native.box_iou3d_batch(a, b, z_axis)
    ref_iou, ref_dist = jnative.box_iou3d_batch(a, b, z_axis)
    np.testing.assert_array_equal(iou, ref_iou)
    np.testing.assert_array_equal(dist, ref_dist)
    assert (iou[:4] == 1).all() and (iou[4:8] == 0).all()


_LOAD = """
import sys
import numpy as np
from ptt_tpu_torch.ops import _build
_build.set_build_dir(sys.argv[1])
from ptt_tpu_torch import native
print(native.fps(np.random.default_rng(0).standard_normal((300, 3)).astype(np.float32), 16).tolist())
"""


def test_concurrent_builds_into_one_directory_all_load(tmp_path):
    """Four processes started together build into one empty directory: each
    writes its own file and renames it into place, so each loads a whole
    library and none sees half of one."""
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err[-2000:] for _, err in outs]
    assert len({out for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ptt_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native._build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.build()
    assert "error" in str(info.value)
    assert not any((tmp_path / "build").iterdir())


def test_build_dir_is_fixed_once_a_library_is_loaded(tmp_path):
    """``_build.set_build_dir`` (compile_diag's ``--build-dir``) raises once this
    process has loaded a library from the old directory."""
    native.fps(np.zeros((8, 3), np.float32), 2)
    before = native._build.BUILD_DIR
    with pytest.raises(RuntimeError, match="already loaded"):
        native._build.set_build_dir(tmp_path)
    assert native._build.BUILD_DIR == before
