"""Training losses as functions of (model outputs, batch labels), the JAX
package's ``nn/losses.py``:

- centroid head: BCE-with-logits over every seed (pos_weight, mean) and a
  smooth-L1 vote regression toward the ground-truth center, masked by the
  per-point in-box labels gathered through the backbone's sample indices;
- box head: objectness labels and mask from the proposal-to-center distance
  (< 0.3 positive, 0.3-0.6 ignored), masked BCE and masked smooth-L1 on
  [x, y, z, theta_deg].
"""

from __future__ import annotations

import torch


def bce_with_logits(logits, labels, pos_weight: float = 1.0):
    """Elementwise BCE with logits in the stable log-add-exp form, positives
    weighted by ``pos_weight``."""
    zero = torch.zeros_like(logits)
    log_sig = -torch.logaddexp(zero, -logits)  # log(sigmoid(x))
    log_one_minus = -torch.logaddexp(zero, logits)  # log(1 - sigmoid(x))
    return -(pos_weight * labels * log_sig + (1.0 - labels) * log_one_minus)


def smooth_l1(pred, target, beta: float = 1.0):
    """Elementwise smooth L1 (Huber with threshold ``beta``)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def centroid_head_losses(outputs, batch, loss_cfg):
    w = loss_cfg["LOSS_WEIGHTS"]
    pos_weight = float(loss_cfg.get("CLS_LOSS_POS_WEIGHT", 1.0))
    cls_label = torch.gather(batch["cls_label"], 1, outputs["search_inds"].long())
    cls_loss = bce_with_logits(outputs["pred_centroids_cls"], cls_label, pos_weight).mean()

    reg_pred = outputs["pred_centroids_votes"]  # (B, n, 3)
    reg_target = batch["reg_label"][:, None, :3].expand_as(reg_pred)
    reg_per_seed = smooth_l1(reg_pred, reg_target).mean(dim=2)
    reg_loss = (reg_per_seed * cls_label).sum() / (cls_label.sum() + 1e-6)

    tb = {"centroids_cls_loss": cls_loss, "centroids_reg_loss": reg_loss}
    return cls_loss * w["centroids_cls_weight"] + reg_loss * w["centroids_reg_weight"], tb


def box_head_losses(outputs, batch, loss_cfg):
    w = loss_cfg["LOSS_WEIGHTS"]
    pos_weight = float(loss_cfg.get("CLS_LOSS_POS_WEIGHT", 1.0))
    centers = outputs["pred_box_center"]  # (B, np, 3)
    gt_center = batch["reg_label"][:, None, 0:3]
    dist = torch.sqrt(((centers - gt_center) ** 2).sum(dim=-1) + 1e-6)
    objectness_label = (dist < 0.3).float()
    objectness_mask = ((dist < 0.3) | (dist > 0.6)).float()

    box_data = outputs["pred_box_data"]  # (B, np, 5)
    cls_elem = bce_with_logits(box_data[..., -1], objectness_label, pos_weight)
    cls_loss = (cls_elem * objectness_mask).sum() / (objectness_mask.sum() + 1e-6)

    reg_pred = box_data[..., :-1]  # (B, np, 4)
    reg_target = batch["reg_label"][:, None, :].expand_as(reg_pred)
    reg_per_prop = smooth_l1(reg_pred, reg_target).mean(dim=2)
    reg_loss = (reg_per_prop * objectness_label).sum() / (objectness_label.sum() + 1e-6)

    tb = {"boxes_cls_loss": cls_loss, "boxes_reg_loss": reg_loss}
    return cls_loss * w["boxes_cls_weight"] + reg_loss * w["boxes_reg_weight"], tb


def compute_losses(model_cfg, outputs, batch):
    """Total training loss = centroid head + box head. Returns (loss, dict of
    the loss terms and ``loss``), all 0-dim tensors."""
    centroid_loss, tb1 = centroid_head_losses(outputs, batch, model_cfg["CENTROID_HEAD"]["LOSS_CONFIG"])
    box_loss, tb2 = box_head_losses(outputs, batch, model_cfg["BOX_HEAD"]["LOSS_CONFIG"])
    loss = centroid_loss + box_loss
    return loss, {**tb1, **tb2, "loss": loss}
