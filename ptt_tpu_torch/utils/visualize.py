"""Point-cloud and tracking plots (the JAX package's ``utils/visualize.py``; the
reference's tools/visual_utils/visualize_utils.py, which uses mayavi).

Headless matplotlib: BEV and 3D scatter of clouds, oriented box wireframes of
``core/geometry.py`` ``Box``es, and a tracklet's trajectory panel. Every
function returns the matplotlib Figure and, given ``save_path``, writes a png.
matplotlib is imported inside the functions, so the rest of the package
imports without it; without it they raise an ImportError that names it.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, and its Polygon patch."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("ptt_tpu_torch.utils.visualize needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    return plt, Polygon


def _box_bev_corners(box) -> np.ndarray:
    """(4, 2) BEV footprint of a geometry.Box."""
    return box.bottom_corners().T[:, :2]


def _finish(fig, save_path):
    plt, _ = _pyplot()
    if save_path is not None:
        fig.savefig(str(save_path), dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_pts(points, color_axis: int = 2, save_path=None, title=None, s=0.5):
    """BEV scatter of an (N, 3+) cloud colored by one axis (reference
    visualize_pts :76)."""
    plt, _ = _pyplot()
    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(7, 7))
    sc = ax.scatter(points[:, 0], points[:, 1], c=points[:, color_axis], s=s, cmap="viridis")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    fig.colorbar(sc, ax=ax, shrink=0.7)
    return _finish(fig, save_path)


def draw_scenes(points, gt_boxes=None, pred_boxes=None, save_path=None, title=None):
    """BEV scene: cloud + GT (green) and predicted (red) box footprints with heading
    ticks (reference draw_scenes :149 / draw_corners3d :205)."""
    plt, MplPolygon = _pyplot()
    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(points[:, 0], points[:, 1], c="#888888", s=0.4)
    for boxes, color in ((gt_boxes, "tab:green"), (pred_boxes, "tab:red")):
        if boxes is None:
            continue
        if not isinstance(boxes, (list, tuple)):
            boxes = [boxes]
        for box in boxes:
            corners = _box_bev_corners(box)
            ax.add_patch(
                MplPolygon(corners, closed=True, fill=False, edgecolor=color, linewidth=1.5)
            )
            # heading tick from center to front-face midpoint
            front_mid = (corners[0] + corners[1]) / 2
            ax.plot(
                [box.center[0], front_mid[0]], [box.center[1], front_mid[1]],
                color=color, linewidth=1.0,
            )
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    return _finish(fig, save_path)


def draw_scenes_3d(points, gt_boxes=None, pred_boxes=None, save_path=None, title=None):
    """3D scatter + box wireframes (reference mayavi_show_np :275)."""
    plt, _ = _pyplot()
    points = np.asarray(points)
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=points[:, 2], s=0.4, cmap="viridis")
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    for boxes, color in ((gt_boxes, "tab:green"), (pred_boxes, "tab:red")):
        if boxes is None:
            continue
        if not isinstance(boxes, (list, tuple)):
            boxes = [boxes]
        for box in boxes:
            c = box.corners().T  # (8, 3)
            for i, j in edges:
                ax.plot(*zip(c[i], c[j]), color=color, linewidth=1.0)
    if title:
        ax.set_title(title)
    return _finish(fig, save_path)


def draw_track(gt_boxes, pred_boxes, save_path=None, title=None):
    """Trajectory overlay for one tracklet: GT vs predicted box centers + start/end
    footprints."""
    plt, MplPolygon = _pyplot()
    gt_c = np.array([b.center[:2] for b in gt_boxes])
    pr_c = np.array([b.center[:2] for b in pred_boxes])
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(gt_c[:, 0], gt_c[:, 1], "-o", color="tab:green", markersize=2, label="GT")
    ax.plot(pr_c[:, 0], pr_c[:, 1], "-o", color="tab:red", markersize=2, label="pred")
    for boxes, color in ((gt_boxes, "tab:green"), (pred_boxes, "tab:red")):
        for box in (boxes[0], boxes[-1]):
            ax.add_patch(
                MplPolygon(_box_bev_corners(box), closed=True, fill=False,
                           edgecolor=color, linewidth=1.0, alpha=0.6)
            )
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    return _finish(fig, save_path)
