"""The plain reference of the PTT / P2B tracker: the forward pass in eval and
train mode as functions of a parameter dict, in plain PyTorch float32, no
kernel, no fused or folded layer, no graph.

It follows the published architecture (Shan et al., "PTT: Point-Track-
Transformer", IROS 2021; Qi et al., "P2B", CVPR 2020) as the configuration
files state it, in the port's channel-last layout and the port's parameter
names, so that the weights the benchmark makes load into both sides under one
name. Departures from a textbook PointNet++ that the configuration asks for,
and that the reference therefore keeps: 'sequence' center sampling (the first
npoint points), the flax BatchNorm rule in train mode (biased batch variance),
ball query padded with the first hit, and every point distance summed in the
fixed order ((x*x + y*y) + z*z), which is what makes FPS and the neighbour
sets exact on exact inputs. The transformer blocks are PTT's TransformerBlock
(kNN vector attention) and MulTransformerBlock (its multi-head form with
LayerNorms, ``mul_transformer``), the latter with LayerNorm's epsilon at 1e-6,
as the configurations' implementations declare it, where PyTorch's default
is 1e-5; dropout is 0 in every configuration and left out.

This module imports torch only: nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6
# the last layer of the vote residual and of the proposal head start at this
# share of their init, so that a tracker on random weights keeps to the cloud
HEAD_SCALE = 0.1


# ------------------------------------------------------------------ parameters


def _linear(specs, name, c_in, c_out, bias, kind="kaiming"):
    specs.append((f"{name}.weight", (c_out, c_in), kind, c_in))
    if bias:
        specs.append((f"{name}.bias", (c_out,), "bias", c_in))


def _bn(specs, name, c):
    for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                       ("running_var", "bn_var"), ("num_batches_tracked", "count")):
        specs.append((f"{name}.{leaf}", (c,) if kind != "count" else (), kind, c))


def _shared_mlp(specs, name, channels, bn=True):
    for i, (a, b) in enumerate(zip(channels[:-1], channels[1:])):
        _linear(specs, f"{name}.linears.{i}", a, b, bias=not bn)
    if bn:
        for i, b in enumerate(channels[1:]):
            _bn(specs, f"{name}.bns.{i}", b)


def _conv_stack(specs, name, channels, last_kind="kaiming"):
    pairs = list(zip(channels[:-1], channels[1:]))
    for i, (a, b) in enumerate(pairs):
        last = i == len(pairs) - 1
        _linear(specs, f"{name}.linears.{i}", a, b, bias=last, kind=last_kind if last else "kaiming")
    for i, (_, b) in enumerate(pairs[:-1]):
        _bn(specs, f"{name}.bns.{i}", b)


def _transformer(specs, name, d_points, d_model):
    _linear(specs, f"{name}.fc1", d_points, d_model, True, "plain")
    for q in ("w_qs", "w_ks", "w_vs"):
        _linear(specs, f"{name}.{q}", d_model, d_model, False, "plain")
    _linear(specs, f"{name}.fc_delta.0", 3, d_model, True, "plain")
    _linear(specs, f"{name}.fc_delta.2", d_model, d_model, True, "plain")
    _linear(specs, f"{name}.fc_gamma.0", d_model, d_model, True, "plain")
    _linear(specs, f"{name}.fc_gamma.2", d_model, d_model, True, "plain")
    _linear(specs, f"{name}.fc2", d_model, d_points, True, "plain")


def _layer_norm(specs, name, c):
    specs.append((f"{name}.weight", (c,), "bn_weight", c))
    specs.append((f"{name}.bias", (c,), "bn_bias", c))


def _mul_transformer(specs, name, d_points, d_model, heads, layers):
    h = d_model // heads
    for i in range(layers):
        n = f"{name}.layers.{i}"
        _linear(specs, f"{n}.fc1", d_points, d_model, True, "plain")
        for q in ("w_qs", "w_ks", "w_vs"):
            _linear(specs, f"{n}.{q}", d_model, d_model, False, "plain")
        _linear(specs, f"{n}.fc_delta.0", 3, d_model, True, "plain")
        _linear(specs, f"{n}.fc_delta.2", d_model, d_model, True, "plain")
        _linear(specs, f"{n}.fc_gamma.0", h, h, True, "plain")
        _linear(specs, f"{n}.fc_gamma.2", h, h, True, "plain")
        _linear(specs, f"{n}.proj", d_model, d_model, False, "plain")
        _layer_norm(specs, f"{n}.norm1", d_model)
        _linear(specs, f"{n}.fc2", d_model, d_points, True, "plain")
        _layer_norm(specs, f"{n}.norm2", d_points)


def _check_transformer(cfg):
    if not cfg["ENABLE"] or cfg["NAME"] == "TransformerBlock":
        return
    if cfg["NAME"] == "MulTransformerBlock" and int(cfg["DIM_MODEL"]) % int(cfg["N_HEADS"]) == 0:
        return
    raise NotImplementedError(f"reference: transformer {cfg['NAME']!r}")


def _block_specs(specs, name, cfg):
    _check_transformer(cfg)
    if not cfg["ENABLE"]:
        return
    if cfg["NAME"] == "MulTransformerBlock":
        _mul_transformer(specs, name, int(cfg["DIM_INPUT"]), int(cfg["DIM_MODEL"]), int(cfg["N_HEADS"]),
                         int(cfg["N_LAYERS"]))
    else:
        _transformer(specs, name, int(cfg["DIM_INPUT"]), int(cfg["DIM_MODEL"]))


def param_specs(model_cfg: dict) -> list:
    """[(name, shape, kind, fan_in)] of every tensor of the tracker's state,
    in the port's names; ``kind`` says how ``make_weights`` fills it."""
    specs = []
    sa = model_cfg["BACKBONE_3D"]["SA_CONFIG"]
    for k, mlps in enumerate(sa["MLPS"]):
        ch = list(mlps)
        ch[0] = (0 if k == 0 else ch[0]) + 3
        _shared_mlp(specs, f"backbone_3d.sa_stages.{k}.mlp", ch)
    _linear(specs, "backbone_3d.cov_final", sa["MLPS"][-1][-1], 256, True, "plain")
    sim = model_cfg["SIMILARITY_MODULE"]
    _shared_mlp(specs, "similarity_module.mlp", sim["MLP"]["CHANNELS"], bn=bool(sim["MLP"]["BN"]))
    if not sim["CONV"]["BN"]:
        raise NotImplementedError("reference: CONV.BN False")
    _conv_stack(specs, "similarity_module.conv", sim["CONV"]["CHANNELS"])
    ch = model_cfg["CENTROID_HEAD"]
    _block_specs(specs, "centroid_voting_head.transformer_block", ch["TRANSFORMER_BLOCK"])
    _conv_stack(specs, "centroid_voting_head.cls_fc", ch["CLS_FC"]["CHANNELS"])
    _conv_stack(specs, "centroid_voting_head.reg_fc", ch["REG_FC"]["CHANNELS"], last_kind="head")
    bh = model_cfg["BOX_HEAD"]
    ch_va = list(bh["SA_CONFIG"]["MLPS"])
    ch_va[0] += 3
    _shared_mlp(specs, "box_voting_head.vote_aggregation.mlp", ch_va)
    _block_specs(specs, "box_voting_head.transformer_block", bh["TRANSFORMER_BLOCK"])
    _conv_stack(specs, "box_voting_head.fc", bh["FC"], last_kind="head")
    return specs


def make_weights(specs, seed: int, device) -> dict:
    """The tracker's state from ``seed``: one normal draw for all of it on
    ``device`` (a ``torch.Generator`` there), cut into the tensors and scaled
    by kind: kaiming normal (std sqrt(2 / fan_in)) for the linear layers
    inside BatchNorm stacks, std 1 / sqrt(fan_in) for the bare ones and their
    biases, HEAD_SCALE times that for the heads' last layers; BatchNorm scale
    1 + 0.1 n, shift 0.1 n, running mean 0.1 n and variance 1 + 0.25 |n|."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, kind, _ in specs if kind != "count"]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, shape, kind, fan_in in specs:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        x = flat[pos:pos + n].reshape(shape)
        pos += n
        if kind == "kaiming":
            x = x * math.sqrt(2.0 / fan_in)
        elif kind in ("plain", "bias"):
            x = x / math.sqrt(fan_in)
        elif kind == "head":
            x = x * (HEAD_SCALE / math.sqrt(fan_in))
        elif kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind in ("bn_bias", "bn_mean"):
            x = 0.1 * x
        elif kind == "bn_var":
            x = 1.0 + 0.25 * x.abs()
        out[name] = x.contiguous()
    return out


# ------------------------------------------------------------------- point ops


def sq_norm(p):
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def square_distance(src, dst):
    """(B, N, 3) x (B, M, 3) -> (B, N, M): |a|^2 + |b|^2 - 2ab in the fixed
    order, clamped at 0."""
    a, b = src[:, :, None, :], dst[:, None, :, :]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    return ((sq_norm(src)[:, :, None] + sq_norm(dst)[:, None, :]) - 2.0 * cross).clamp_min(0.0)


def fps(xyz, npoint: int):
    """Farthest point sampling from index 0, ties to the lowest index. On the
    meta device (shapes only, ``counts/flops.py``) the picks are zeros: they
    move no operation the counter counts."""
    B, N, _ = xyz.shape
    if xyz.is_meta:
        return torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    idx = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    lane = torch.arange(N, device=xyz.device).expand(B, N)
    for i in range(npoint):
        idx[:, i] = far
        min_d2 = torch.minimum(min_d2, sq_norm(xyz - xyz[rows, far][:, None, :]))
        top = min_d2.amax(dim=1, keepdim=True)
        far = torch.where(min_d2 == top, lane, N).amin(dim=1)
    return idx


def gather(points, idx):
    """(B, N, C) x (B, ...) -> (B, ..., C)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def radius_sq(radius: float) -> float:
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def ball_query(radius: float, nsample: int, xyz, centers):
    """The first ``nsample`` points strictly inside float32(radius^2) of each
    center, in index order, short rows padded with the first hit, no hit:
    point 0."""
    d2 = square_distance(centers, xyz)
    N = xyz.shape[1]
    order = torch.arange(N, device=xyz.device).expand_as(d2)
    key = torch.where(d2 < radius_sq(radius), order, order + N)
    key = torch.topk(key, min(nsample, N), dim=-1, largest=False, sorted=True).values
    valid = key < N
    idx = torch.where(valid, key, key - N)
    return torch.where(valid, idx, idx[..., :1])


def knn(k: int, xyz):
    return torch.argsort(square_distance(xyz, xyz), dim=-1, stable=True)[..., :k]


# ---------------------------------------------------------------------- layers


def linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def batch_norm(P, name, x, train: bool):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def layer_norm(P, name, x):
    """Over the last axis, biased variance, epsilon LN_EPS."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]


def shared_mlp(P, name, x, layers: int, train: bool, bn: bool = True):
    for i in range(layers):
        x = linear(P, f"{name}.linears.{i}", x)
        if bn:
            x = batch_norm(P, f"{name}.bns.{i}", x, train)
        x = torch.relu(x)
    return x


def conv_stack(P, name, x, layers: int, train: bool):
    for i in range(layers):
        x = linear(P, f"{name}.linears.{i}", x)
        if i < layers - 1:
            x = torch.relu(batch_norm(P, f"{name}.bns.{i}", x, train))
    return x


def set_abstraction(P, name, xyz, features, centers, radius, nsample, layers, train, calls=None):
    """Ball query around ``centers``, [relative xyz / radius | features] per
    neighbour, the shared MLP, the max over the neighbourhood. ``calls``, a
    list, receives (xyz, centers, feature width, radius, nsample, the MLP's
    widths) of the call, which ``counts/`` reads."""
    if calls is not None:
        widths = [P[f"{name}.linears.{i}.weight"].shape[0] for i in range(layers)]
        calls.append((xyz, centers, 0 if features is None else features.shape[-1], radius, nsample, widths))
    idx = ball_query(radius, nsample, xyz, centers)
    rel = (gather(xyz, idx) - centers[:, :, None, :]) / radius
    h = rel if features is None else torch.cat([rel, gather(features, idx)], dim=-1)
    return shared_mlp(P, name, h, layers, train).amax(dim=2)


def transformer(P, name, xyz, features, d_model: int, k: int):
    """kNN vector attention (PTT's TransformerBlock)."""
    idx = knn(k, xyz)
    x = linear(P, f"{name}.fc1", features)
    q = linear(P, f"{name}.w_qs", x)
    kk = gather(linear(P, f"{name}.w_ks", x), idx)
    v = gather(linear(P, f"{name}.w_vs", x), idx)
    delta = gather(xyz, idx)
    pos = linear(P, f"{name}.fc_delta.2", torch.relu(linear(P, f"{name}.fc_delta.0", xyz[:, :, None] - delta)))
    g = q[:, :, None] - kk + pos
    logits = linear(P, f"{name}.fc_gamma.2", torch.relu(linear(P, f"{name}.fc_gamma.0", g)))
    attn = torch.softmax(logits / math.sqrt(d_model), dim=-2)
    return linear(P, f"{name}.fc2", (attn * (v + pos)).sum(dim=-2)) + features


def mul_transformer(P, name, xyz, features, d_model: int, k: int, heads: int, layers: int):
    """PTT's MulTransformerBlock: ``layers`` layers of kNN vector attention
    with the d_model channels split into ``heads`` heads of h = d_model /
    heads. Each layer: x = fc1(f); per head, the logits fc_gamma(q_i - k_j +
    delta_ij) of one h -> h -> h MLP shared by the heads, softmaxed over the
    neighbours j per channel at scale 1 / sqrt(h), weight the values v_j +
    delta_ij; the heads concatenated in order, then norm1(proj(.)) and f <-
    norm2(fc2(.)) + f. The neighbours (self included) depend on ``xyz`` alone,
    so every layer has the same."""
    idx = knn(k, xyz)
    rel = xyz[:, :, None] - gather(xyz, idx)
    h = d_model // heads

    def split(t):  # (B, N, k or 1, d_model) -> (B, N, k or 1, heads, h)
        return t.reshape(*t.shape[:-1], heads, h)

    for i in range(layers):
        n = f"{name}.layers.{i}"
        x = linear(P, f"{n}.fc1", features)
        q = linear(P, f"{n}.w_qs", x)[:, :, None]
        kk = gather(linear(P, f"{n}.w_ks", x), idx)
        v = gather(linear(P, f"{n}.w_vs", x), idx)
        pos = linear(P, f"{n}.fc_delta.2", torch.relu(linear(P, f"{n}.fc_delta.0", rel)))
        logits = linear(P, f"{n}.fc_gamma.2", torch.relu(linear(P, f"{n}.fc_gamma.0", split(q - kk + pos))))
        attn = torch.softmax(logits / math.sqrt(h), dim=2)
        r = (attn * split(v + pos)).sum(dim=2).flatten(-2)
        y = layer_norm(P, f"{n}.norm1", linear(P, f"{n}.proj", r))
        features = layer_norm(P, f"{n}.norm2", linear(P, f"{n}.fc2", y)) + features
    return features


def transformer_block(P, name, xyz, features, cfg: dict):
    """The block that TRANSFORMER_BLOCK ``cfg`` names."""
    _check_transformer(cfg)
    if cfg["NAME"] == "MulTransformerBlock":
        return mul_transformer(P, name, xyz, features, int(cfg["DIM_MODEL"]), int(cfg["KNN"]), int(cfg["N_HEADS"]),
                               int(cfg["N_LAYERS"]))
    return transformer(P, name, xyz, features, int(cfg["DIM_MODEL"]), int(cfg["KNN"]))


# ----------------------------------------------------------------------- model


def _centers(method, xyz, npoint):
    if method == "fps":
        return fps(xyz, npoint)
    if method in ("sequence", "rs"):
        return torch.arange(npoint, device=xyz.device).expand(xyz.shape[0], npoint)
    raise NotImplementedError(f"reference: sample method {method!r}")


def _branch(P, sa, points, npoints, train, calls):
    xyz, feats, inds = points, None, None
    for k, npoint in enumerate(npoints):
        sel = _centers(sa["SAMPLE_METHOD"][k], xyz, int(npoint))
        centers = gather(xyz, sel)
        feats = set_abstraction(P, f"backbone_3d.sa_stages.{k}.mlp", xyz, feats, centers, float(sa["RADIUS"][k]),
                                int(sa["NSAMPLE"][k]), len(sa["MLPS"][k]) - 1, train, calls)
        xyz = centers
        inds = sel if inds is None else torch.gather(inds, 1, sel)
    return xyz, linear(P, "backbone_3d.cov_final", feats), inds


def forward(P, model_cfg: dict, search, template, train: bool = False, calls=None) -> dict:
    """search (B, S, 3), template (B, T, 3) -> the outputs the losses and the
    tracker read: search_inds, pred_centroids_cls, pred_centroids_votes,
    pred_box_center, pred_box_data (B, np, 5) = [cx, cy, cz, theta_deg, score].
    ``calls``: as ``set_abstraction``'s, for every SA call in order."""
    sa = model_cfg["BACKBONE_3D"]["SA_CONFIG"]
    s_xyz, s_feat, s_inds = _branch(P, sa, search, sa["NPOINTS_SEARCH"], train, calls)
    t_xyz, t_feat, _ = _branch(P, sa, template, sa["NPOINTS_TEMPLATE"], train, calls)

    sim_cfg = model_cfg["SIMILARITY_MODULE"]
    t_n = t_feat / t_feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    s_n = s_feat / s_feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    sim = torch.bmm(t_n, s_n.transpose(1, 2))  # (B, n1, n2)
    B, n1, n2 = sim.shape
    pair = torch.cat([sim[..., None], t_xyz[:, :, None, :].expand(B, n1, n2, 3),
                      t_feat[:, :, None, :].expand(B, n1, n2, t_feat.shape[-1])], dim=-1)
    fused = shared_mlp(P, "similarity_module.mlp", pair, len(sim_cfg["MLP"]["CHANNELS"]) - 1, train,
                       bn=bool(sim_cfg["MLP"]["BN"])).amax(dim=1)
    fusion = conv_stack(P, "similarity_module.conv", fused, len(sim_cfg["CONV"]["CHANNELS"]) - 1, train)

    ch = model_cfg["CENTROID_HEAD"]
    tb = ch["TRANSFORMER_BLOCK"]
    if tb["ENABLE"]:
        fusion = transformer_block(P, "centroid_voting_head.transformer_block", s_xyz, fusion, tb)
    if ch.get("CLS_USE_SEARCH_XYZ", False):
        raise NotImplementedError("reference: CLS_USE_SEARCH_XYZ")
    cls = conv_stack(P, "centroid_voting_head.cls_fc", fusion, len(ch["CLS_FC"]["CHANNELS"]) - 1, train)[..., 0]
    vote_in = torch.cat([s_xyz, fusion], dim=-1)
    votes = vote_in + conv_stack(P, "centroid_voting_head.reg_fc", vote_in, len(ch["REG_FC"]["CHANNELS"]) - 1,
                                 train)
    vote_xyz = votes[..., 0:3].contiguous()
    vote_feat = torch.cat([torch.sigmoid(cls)[..., None], votes[..., 3:]], dim=-1)

    bh = model_cfg["BOX_HEAD"]
    va = bh["SA_CONFIG"]
    if va["SAMPLE_METHOD"] != "fps":
        raise NotImplementedError("reference: vote sampling other than fps")
    centers = gather(vote_xyz, fps(vote_xyz, int(va["NPOINTS"])))
    props = set_abstraction(P, "box_voting_head.vote_aggregation.mlp", vote_xyz, vote_feat, centers,
                            float(va["RADIUS"]), int(va["NSAMPLE"]), len(va["MLPS"]) - 1, train, calls)
    tb = bh["TRANSFORMER_BLOCK"]
    if tb["ENABLE"]:
        props = transformer_block(P, "box_voting_head.transformer_block", centers, props, tb)
    off = conv_stack(P, "box_voting_head.fc", props, len(bh["FC"]) - 1, train)
    return {"search_inds": s_inds, "pred_centroids_cls": cls, "pred_centroids_votes": vote_xyz,
            "pred_box_center": centers,
            "pred_box_data": torch.cat([off[..., 0:3] + centers, off[..., 3:]], dim=-1)}
