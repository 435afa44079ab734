"""The reference of a train step, in plain PyTorch: the train-mode forward of
``model.forward`` (BatchNorm on batch statistics), the losses of PTT / P2B,
the backward by autograd, the clip by global norm and the Adam update of the
OPTIMIZATION section (optax's order: clip, then scale_by_adam, then the
learning rate; gradients scaled only when the norm reaches the clip).

Losses: the centroid head's BCE with logits over every seed (mean) and its
smooth-L1 vote regression masked by the seeds' in-box labels; the box head's
objectness (< 0.3 m of the ground-truth center positive, 0.3-0.6 m ignored)
as a masked BCE with POS_WEIGHT, and a smooth-L1 on [x, y, z, theta_deg]
over the positives; masked means divide by the mask's sum + 1e-6.

Imports torch only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as ref_model


def bce(logits, labels, pos_weight: float):
    return -(pos_weight * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_mean(values, mask):
    return (values * mask).sum() / (mask.sum() + 1e-6)


def losses(model_cfg: dict, out: dict, batch: dict) -> dict:
    """The loss terms and their weighted sum ``loss``."""
    ch = model_cfg["CENTROID_HEAD"]["LOSS_CONFIG"]
    bh = model_cfg["BOX_HEAD"]["LOSS_CONFIG"]
    cls_label = torch.gather(batch["cls_label"], 1, out["search_inds"])
    c_cls = bce(out["pred_centroids_cls"], cls_label, float(ch.get("CLS_LOSS_POS_WEIGHT", 1.0))).mean()
    votes = out["pred_centroids_votes"]
    c_reg = masked_mean(smooth_l1(votes, batch["reg_label"][:, None, :3].expand_as(votes)).mean(2), cls_label)
    centers = out["pred_box_center"]
    dist = torch.sqrt(((centers - batch["reg_label"][:, None, 0:3]) ** 2).sum(-1) + 1e-6)
    pos = (dist < 0.3).float()
    keep = ((dist < 0.3) | (dist > 0.6)).float()
    data = out["pred_box_data"]
    b_cls = masked_mean(bce(data[..., -1], pos, float(bh.get("CLS_LOSS_POS_WEIGHT", 1.0))), keep)
    reg = data[..., :-1]
    b_reg = masked_mean(smooth_l1(reg, batch["reg_label"][:, None, :].expand_as(reg)).mean(2), pos)
    cw, bw = ch["LOSS_WEIGHTS"], bh["LOSS_WEIGHTS"]
    loss = (c_cls * cw["centroids_cls_weight"] + c_reg * cw["centroids_reg_weight"]
            + b_cls * bw["boxes_cls_weight"] + b_reg * bw["boxes_reg_weight"])
    return {"centroids_cls_loss": c_cls, "centroids_reg_loss": c_reg, "boxes_cls_loss": b_cls,
            "boxes_reg_loss": b_reg, "loss": loss}


class Adam:
    """Adam of an OPTIMIZATION section with OPTIMIZER adam, no weight decay,
    and the step schedule's learning rate at epoch 0 (the first steps of a
    run): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr m_hat /
    (sqrt(v_hat) + eps)."""

    def __init__(self, names, params: dict, optim_cfg: dict, state=None):
        if optim_cfg["OPTIMIZER"] != "adam" or float(optim_cfg.get("WEIGHT_DECAY", 0.0)) != 0.0:
            raise NotImplementedError("reference: adam without weight decay only")
        self.names = list(names)
        self.lr = float(optim_cfg["LR"])
        self.b1, self.b2 = (float(b) for b in optim_cfg.get("BETAS", [0.9, 0.999]))
        self.eps = float(optim_cfg.get("EPS", 1e-8))
        clip = optim_cfg.get("GRAD_NORM_CLIP")
        self.clip = None if clip is None else float(clip)
        if state is None:
            self.m = {n: torch.zeros_like(params[n]) for n in self.names}
            self.v = {n: torch.zeros_like(params[n]) for n in self.names}
            self.count = 0
        else:  # (m, v, count) of a run to go on from
            m, v, self.count = state
            self.m = {n: m[n].detach().clone() for n in self.names}
            self.v = {n: v[n].detach().clone() for n in self.names}

    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if self.clip is not None and norm >= self.clip:
            return {n: g / norm * self.clip for n, g in grads.items()}
        return grads

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for n in self.names:
            g = grads[n]
            self.m[n] = self.b1 * self.m[n] + (1.0 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1.0 - self.b2) * g * g
            params[n] = params[n] - self.lr * (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + self.eps)


def trainable(specs) -> list:
    """The names of the parameters Adam updates (not BatchNorm's running
    statistics or counters)."""
    return [name for name, _, kind, _ in specs if kind not in ("bn_mean", "bn_var", "count")]


def steps(model_cfg: dict, optim_cfg: dict, state: dict, batches, device, adam_state=None) -> dict:
    """The train steps of ``batches`` (dicts of (B, ...) numpy arrays) from
    ``state`` (the weights before the first step) and ``adam_state`` (Adam's
    (m, v, count) before it; none: a fresh optimizer): each step's loss
    terms, the first step's clipped gradients, and the parameters after the
    last step."""
    names = trainable(ref_model.param_specs(model_cfg))
    params = {k: v.detach().clone() for k, v in state.items()}
    opt = Adam(names, params, optim_cfg, adam_state)
    out = {"losses": [], "grad1": None, "params": None}
    for batch in batches:
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        P = dict(params, **leaves)
        terms = losses(model_cfg, ref_model.forward(P, model_cfg, b["search_points"], b["template_points"],
                                                    train=True), b)
        grads = torch.autograd.grad(terms["loss"], [leaves[n] for n in names], allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None else g) for n, g in zip(names, grads)}
        grads = opt.clipped(grads)
        if out["grad1"] is None:
            out["grad1"] = {n: g.detach().clone() for n, g in grads.items()}
        opt.update(params, grads)
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        del leaves, P, terms, grads
    out["params"] = {n: params[n] for n in names}
    return out
