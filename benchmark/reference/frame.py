"""The reference of one frame step of the batched tracker (TEST.REF_BOX
previous_result), in plain PyTorch: the upload's int16 grid, the search crop
around the previous box, the template of SHAPE_AGGREGATION, the resample from
given uniforms, then ``model.forward``, the best proposal and its decode.

The crop and the resample are written with the same operations, in the same
order and at the same (B, N) shapes as the deployed tracker uses them: a
point on a crop's boundary is in or out by the last bit of its canonical
coordinates, and one point more or less moves every pick of the resample. So
the reference crops each dispatched batch at frame t as one (B, N) call, as
the program does, from the clouds and the boxes the program was given or
returned, and re-derives every tensor the program made from them.

Imports torch and numpy only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

QUANT_SCALE = 1.0 / 256.0
FRAME_BUCKET = 32  # the tracker pads a batch's frames to a multiple of this, and steps through the padding


def padded_frames(T: int) -> int:
    return max(2, -(-T // FRAME_BUCKET) * FRAME_BUCKET)


def box_vec(box) -> np.ndarray:
    """[cx, cy, cz, yaw] of a ``Box`` as float32."""
    yaw = np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0])
    return np.array([*box.center, yaw], np.float32)


def pack(tracklets, n_pad: int, seed: int) -> dict:
    """A batch of equal-length tracklets on the upload's grid: pcs (B, T, n_pad,
    3) int16, counts (B, T), init (B, 4), wlhs (B, 3), gt (B, T, 4). A frame
    of more than ``n_pad`` points keeps ``n_pad`` of them, drawn without
    replacement as the tracker draws them: a ``np.random.default_rng(seed)``
    for each tracklet, ``seed`` the tracker's, one draw for each frame cut."""
    B, T = len(tracklets), len(tracklets[0][0])
    pcs = np.zeros((B, T, n_pad, 3), np.int16)
    counts = np.zeros((B, T), np.int32)
    init = np.zeros((B, 4), np.float32)
    wlhs = np.zeros((B, 3), np.float32)
    gt = np.zeros((B, T, 4), np.float32)
    for b, (clouds, boxes, _) in enumerate(tracklets):
        rng = np.random.default_rng(seed)
        for t, pc in enumerate(clouds):
            pc = np.asarray(pc, np.float32)
            if len(pc) > n_pad:
                pc = pc[rng.choice(len(pc), n_pad, replace=False)]
            pcs[b, t, :len(pc)] = np.clip(np.round(pc / QUANT_SCALE), -32768, 32767)
            counts[b, t] = len(pc)
        init[b] = box_vec(boxes[0])
        wlhs[b] = boxes[0].wlh
        gt[b] = np.stack([box_vec(g) for g in boxes])
    return {"pcs": pcs, "counts": counts, "init": init, "wlhs": wlhs, "gt": gt}


def rot_z(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def crop(pts, valid, box, wlh, offset, scale: float):
    """Canonical coordinates and the mask of the points in the scaled box."""
    canon = torch.matmul(pts - box[:, None, :3], rot_z(box[:, 3]))
    if isinstance(offset, torch.Tensor):
        offset = offset.reshape(-1, 1)
    w, l, h = wlh.unbind(-1)
    half = torch.stack([l / 2 * scale, w / 2 * scale, h / 2 * scale], -1) + offset
    return canon, (canon.abs() <= half[:, None, :]).all(-1) & valid


def precrop(pts, box, wlh, offset: float, scale: float):
    """The loose world-frame box of the search crop."""
    c, s = torch.cos(box[:, 3]).abs(), torch.sin(box[:, 3]).abs()
    hx, hy, hz = 2.0 * scale * wlh[:, 1], 2.0 * scale * wlh[:, 0], 2.0 * scale * wlh[:, 2]
    half = (torch.stack([c * hx + s * hy, s * hx + c * hy, hz], -1) + 2.0 * offset)[:, None, :]
    d = pts - box[:, None, :3]
    return ((d < half) & (d > -half)).all(-1)


def resample(pts, mask, u):
    """Each row's masked points resampled with replacement at the picks of
    the uniforms ``u`` (B, n); rows of <= 2 points give zeros."""
    csum = torch.cumsum(mask, dim=-1)
    count = csum[:, -1]
    hi = count[:, None].clamp_min(1)
    picks = torch.minimum((u * hi).long(), hi - 1)
    rows = torch.searchsorted(csum, picks + 1, side="left").clamp_max(mask.shape[1] - 1)
    out = torch.gather(pts, 1, rows[..., None].expand(-1, -1, 3))
    return torch.where((count > 2)[:, None, None], out, torch.zeros_like(out))


def decode(box, offset4, use_z: bool):
    dz = offset4[:, 2] if use_z else torch.zeros_like(offset4[:, 2])
    delta = torch.stack([offset4[:, 0], offset4[:, 1], dz], -1)
    center = box[:, :3] + torch.matmul(delta[:, None, :], rot_z(box[:, 3]).transpose(1, 2))[:, 0]
    return torch.cat([center, (box[:, 3] + offset4[:, 3] * (math.pi / 180.0))[:, None]], -1)


class FrameInputs:
    """The crops of a packed batch on ``device``, under DATA_CONFIG ``data``
    and TEST ``test``: ``inputs(t, prev_t, prev_prev)`` gives the search and
    template clouds of frame t from the boxes the tracker returned for frames
    t - 1 (the search's reference and the previous template's box)."""

    def __init__(self, packed: dict, data: dict, test: dict, device):
        if str(test.get("REF_BOX", "previous_result")).upper() != "PREVIOUS_RESULT":
            raise NotImplementedError("reference: REF_BOX other than previous_result")
        self.mode = str(test.get("SHAPE_AGGREGATION", "firstandprevious")).upper()
        if self.mode not in ("FIRSTANDPREVIOUS", "FIRST", "PREVIOUS"):
            raise NotImplementedError(f"reference: SHAPE_AGGREGATION {self.mode}")
        self.pcs = torch.from_numpy(packed["pcs"]).to(device)
        counts = torch.from_numpy(packed["counts"]).to(device)
        self.init = torch.from_numpy(packed["init"]).to(device)
        self.wlhs = torch.from_numpy(packed["wlhs"]).to(device)
        N = self.pcs.shape[2]
        self.valid = torch.arange(N, device=device)[None, None, :] < counts[:, :, None]
        self.s_offset = float(data.get("SEARCH_BB_OFFSET", 0.0))
        self.s_scale = float(data.get("SEARCH_BB_SCALE", 1.25))
        self.m_offset = float(data.get("MODEL_BB_OFFSET", 0.0))
        self.m_scale = float(data.get("MODEL_BB_SCALE", 1.25))
        self.search_offsets = self.s_offset + 0.6 * self.wlhs[:, 1]
        self.first = crop(self.frame(0), self.valid[:, 0], self.init, self.wlhs, self.m_offset, self.m_scale)

    def frame(self, t: int):
        return self.pcs[:, t].float() * QUANT_SCALE

    def inputs(self, t: int, prev_box, u_search, u_template):
        """(search (B, S, 3), template (B, P, 3)) of frame t, cropped around
        ``prev_box`` (B, 4), the boxes of frame t - 1."""
        cur = self.frame(t)
        canon, mask = crop(cur, self.valid[:, t], prev_box, self.wlhs, self.search_offsets, self.s_scale)
        mask &= precrop(cur, prev_box, self.wlhs, self.s_offset, self.s_scale)
        search = resample(canon, mask, u_search)
        if self.mode == "FIRST":
            tmpl, tmask = self.first
        else:
            tmpl, tmask = crop(self.frame(t - 1), self.valid[:, t - 1], prev_box, self.wlhs, self.m_offset,
                               self.m_scale)
            if self.mode == "FIRSTANDPREVIOUS":
                tmpl, tmask = torch.cat([self.first[0], tmpl], 1), torch.cat([self.first[1], tmask], 1)
        return search, resample(tmpl, tmask, u_template)


def uniforms(seed: int, T: int, B: int, search: int, template: int, device):
    """The tracker's uniforms of a batch: (T - 1, B, search) then (T - 1, B,
    template) from a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return (torch.rand((T - 1, B, search), generator=gen, device=device),
            torch.rand((T - 1, B, template), generator=gen, device=device))


def best_box(pred_box_data, ref_box, use_z: bool):
    """The decoded box of the best proposal (first of equal maxima)."""
    score = pred_box_data[:, :, 4]
    top = score.amax(dim=1, keepdim=True)
    lane = torch.arange(score.shape[1], device=score.device).expand_as(score)
    idx = torch.where(score == top, lane, score.shape[1]).amin(dim=1)
    best = pred_box_data[torch.arange(score.shape[0], device=score.device), idx]
    return decode(ref_box, best[:, :4], use_z)
